"""whisper-base [audio] — 6L encoder + 6L decoder, d_model=512 8H
d_ff=2048 vocab=51865 — enc-dec; conv frontend is a STUB (input_specs
provides precomputed frame embeddings); decoder context 448
[arXiv:2212.04356]."""
from .base import LayerSpec, ModelConfig

ARCH_ID = "whisper-base"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio", d_model=512, vocab_size=51865,
        encoder_layers=(LayerSpec(count=6, mixer="attn", ffn="dense",
                                  causal=False),),
        layers=(LayerSpec(count=6, mixer="attn", ffn="dense",
                          cross_attn=True),),
        n_heads=8, n_kv_heads=8, head_dim=64, use_rope=False,
        d_ff=2048, ffn_act="gelu", ffn_bias=True, qkv_bias=True,
        use_layernorm=True, learned_pos_embed=True, decoder_len=448,
        frontend="audio_frames", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        d_model=64, vocab_size=256,
        encoder_layers=(LayerSpec(count=2, mixer="attn", ffn="dense",
                                  causal=False),),
        layers=(LayerSpec(count=2, mixer="attn", ffn="dense",
                          cross_attn=True),),
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, decoder_len=16,
    )
