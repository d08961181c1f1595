"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
llama-arch GQA [arXiv:2403.04652; hf]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "yi-9b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", d_model=4096, vocab_size=64000,
        layers=(LayerSpec(count=48, mixer="attn", ffn="dense"),),
        n_heads=32, n_kv_heads=4, head_dim=128, rope_theta=5e6,
        d_ff=11008, ffn_act="silu_glu",
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(LayerSpec(count=2, mixer="attn", ffn="dense"),),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    )
