"""mamba2-2.7b [ssm] — 64L d_model=2560 attention-free, SSD state 128,
expand 2 (d_inner=5120, 80 heads of dim 64), vocab=50280
[arXiv:2405.21060]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "mamba2-2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm", d_model=2560, vocab_size=50280,
        layers=(LayerSpec(count=64, mixer="ssm", ffn="none"),),
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_ngroups=1,
        ssm_chunk=128, tie_embeddings=True, use_rope=False,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        layers=(LayerSpec(count=2, mixer="ssm", ffn="none"),),
        ssm_state=8, ssm_head_dim=8, ssm_chunk=16,
    )
