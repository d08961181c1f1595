"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings [hf:meta-llama/Llama-3.2-1B]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "llama3.2-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", d_model=2048, vocab_size=128256,
        layers=(LayerSpec(count=16, mixer="attn", ffn="dense"),),
        n_heads=32, n_kv_heads=8, head_dim=64, rope_theta=500000.0,
        d_ff=8192, ffn_act="silu_glu", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(LayerSpec(count=2, mixer="attn", ffn="dense"),),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    )
