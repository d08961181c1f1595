"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, sliding window 4096, LayerNorm + biases
[arXiv:2402.19173; hf]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "starcoder2-3b"
WINDOW = 4096


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense", d_model=3072, vocab_size=49152,
        layers=(LayerSpec(count=30, mixer="attn", ffn="dense",
                          windows=(WINDOW,) * 30),),
        n_heads=24, n_kv_heads=2, head_dim=128, rope_theta=999999.0,
        d_ff=12288, ffn_act="gelu", ffn_bias=True, qkv_bias=True,
        use_layernorm=True, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(LayerSpec(count=2, mixer="attn", ffn="dense",
                          windows=(8, 8)),),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    )
