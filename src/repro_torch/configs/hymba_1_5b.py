"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer;
3 global-attention layers (first/middle/last), sliding window 1024 elsewhere
[arXiv:2411.13676; hf]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "hymba-1.5b"
SWA = 1024


def _hybrid_groups(swa_counts, swa: int) -> tuple:
    """Global / SWA layers as window-homogeneous groups so rolling caches
    stay small for the SWA layers (lm.group_kv_len): layout is
    global, swa×a, global, swa×b, global (first/middle/last global)."""
    def g(count, window):
        return LayerSpec(count=count, mixer="attn_ssm_parallel", ffn="dense",
                         windows=(window,) * count)
    a, b = swa_counts
    return (g(1, 0), g(a, swa), g(1, 0), g(b, swa), g(1, 0))


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid", d_model=1600, vocab_size=32001,
        layers=_hybrid_groups((14, 15), SWA),
        n_heads=25, n_kv_heads=5, head_dim=64, rope_theta=1e4,
        d_ff=5504, ffn_act="silu_glu",
        ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    def g(count, window):
        return LayerSpec(count=count, mixer="attn_ssm_parallel", ffn="dense",
                         windows=(window,) * count)
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(g(1, 0), g(1, 8)),
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        ssm_state=8, ssm_head_dim=8, ssm_chunk=16,
    )
