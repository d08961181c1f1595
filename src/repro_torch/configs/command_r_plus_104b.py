"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "command-r-plus-104b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", d_model=12288, vocab_size=256000,
        layers=(LayerSpec(count=64, mixer="attn", ffn="dense"),),
        n_heads=96, n_kv_heads=8, head_dim=128, rope_theta=75e6,
        d_ff=33792, ffn_act="silu_glu", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(LayerSpec(count=2, mixer="attn", ffn="dense"),),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    )
