"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2, attention/logit soft-capping
[hf:xai-org/grok-1]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "grok-1-314b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", d_model=6144, vocab_size=131072,
        layers=(LayerSpec(count=64, mixer="attn", ffn="moe"),),
        n_heads=48, n_kv_heads=8, head_dim=128, rope_theta=1e4,
        n_experts=8, top_k_experts=2, d_ff_expert=32768,
        attn_logit_softcap=30.0, logit_softcap=30.0,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(LayerSpec(count=2, mixer="attn", ffn="moe"),),
        n_heads=4, n_kv_heads=2, head_dim=16,
        n_experts=4, top_k_experts=2, d_ff_expert=64, moe_group_size=16,
        capacity_factor=4 / 2,  # dropless at smoke scale (see deepseek note)
    )
