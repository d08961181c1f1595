"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512,
first layer dense (d_ff=12288), 59 MoE layers: 2 shared + 160 routed top-6
experts (d_ff_expert=1536), vocab=102400 [arXiv:2405.04434; hf]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "deepseek-v2-236b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe", d_model=5120, vocab_size=102400,
        layers=(
            LayerSpec(count=1, mixer="attn", ffn="dense"),
            LayerSpec(count=59, mixer="attn", ffn="moe"),
        ),
        n_heads=128, rope_theta=1e4,
        use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        d_ff=12288, ffn_act="silu_glu",
        n_experts=160, n_shared_experts=2, top_k_experts=6, d_ff_expert=1536,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(
            LayerSpec(count=1, mixer="attn", ffn="dense"),
            LayerSpec(count=2, mixer="attn", ffn="moe"),
        ),
        n_heads=4, kv_lora_rank=16, q_lora_rank=24,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        d_ff=128, n_experts=8, n_shared_experts=1, top_k_experts=2,
        d_ff_expert=32, moe_group_size=16,
        # dropless at smoke scale: capacity = group size ⇒ routing output is
        # exactly grouping-invariant (prefill/forward parity tests rely on it)
        capacity_factor=8 / 2,
    )
