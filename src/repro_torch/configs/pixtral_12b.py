"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo backbone. The vision frontend is a
STUB: input_specs provides precomputed patch embeddings blended into the
sequence prefix [hf:mistralai/Pixtral-12B-2409]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "pixtral-12b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm", d_model=5120, vocab_size=131072,
        layers=(LayerSpec(count=40, mixer="attn", ffn="dense"),),
        n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=1e9,
        d_ff=14336, ffn_act="silu_glu",
        frontend="vision_patches", n_patches=1024,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(LayerSpec(count=2, mixer="attn", ffn="dense"),),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, n_patches=8,
    )
