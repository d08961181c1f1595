"""Model / shape configuration schema covering all assigned architectures:
a copy of the reference's ``configs.base`` (plain data, held field by
field against it in the tests).

A model is a token embedding + a sequence of *layer groups* (each group is a
stack of identical layers; the port runs them in a loop) + final norm + LM
head.
Heterogeneous stacks (e.g. DeepSeek's dense first layer before 59 MoE
layers, Whisper's encoder vs decoder) are expressed as multiple groups.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One scanned group of identical layers."""

    count: int
    mixer: str = "attn"  # attn | ssm | attn_ssm_parallel | none
    ffn: str = "dense"  # dense | moe | none
    cross_attn: bool = False  # decoder group attending to encoder states
    causal: bool = True
    # per-layer sliding window; 0 = full attention. len must be count (or
    # empty = all full). Mixed windows (hymba) stay scannable because the
    # window enters the kernel as data, not structure.
    windows: Tuple[int, ...] = ()

    def window_list(self) -> Tuple[int, ...]:
        return self.windows if self.windows else (0,) * self.count


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    layers: Tuple[LayerSpec, ...]  # decoder stack
    encoder_layers: Tuple[LayerSpec, ...] = ()  # enc-dec archs only
    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 1e4
    use_rope: bool = True
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0  # grok-style tanh capping (0 = off)
    # ---- MLA (DeepSeek-V2) ----
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # ---- FFN ----
    d_ff: int = 0
    ffn_bias: bool = False
    ffn_act: str = "silu_glu"  # silu_glu | gelu_glu | gelu | silu
    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k_experts: int = 0
    d_ff_expert: int = 0
    moe_group_size: int = 512
    capacity_factor: float = 1.25
    router_scale: bool = True  # normalize top-k router weights to sum to 1
    # ---- SSM (Mamba-2 SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # ---- enc-dec / frontends ----
    decoder_len: int = 0  # fixed decoder length for enc-dec (whisper: 448)
    frontend: str = "none"  # none | audio_frames | vision_patches
    n_patches: int = 0  # vision: patch embeddings blended into the prefix
    use_layernorm: bool = False  # whisper uses LN+bias; others RMSNorm
    learned_pos_embed: bool = False  # whisper decoder
    # ---- misc ----
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    remat: bool = False  # checkpoint each scanned layer body
    # Megatron-style sequence parallelism: residual stream / norms /
    # remat-saved activations sharded over `model` on the sequence dim;
    # attention & FFN gather/scatter at their boundaries (§Perf iteration 3)
    seq_parallel: bool = False

    # ---- derived ----
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def n_layers(self) -> int:
        return sum(s.count for s in self.layers) + sum(s.count for s in self.encoder_layers)

    @property
    def is_encoder_decoder(self) -> bool:
        return len(self.encoder_layers) > 0

    @property
    def attention_free(self) -> bool:
        return all(s.mixer == "ssm" for s in self.layers + self.encoder_layers)

    @property
    def max_window(self) -> int:
        """Largest sliding window (0 if any layer is full attention)."""
        ws = []
        for s in self.layers:
            ws.extend(s.window_list())
        return 0 if any(w == 0 for w in ws) else max(ws)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_dtypes(self, param, activation) -> "ModelConfig":
        return self.replace(param_dtype=param, activation_dtype=activation)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k needs sub-quadratic attention; enc-dec
    encoder is full-attention over frames (whisper skips long)."""
    if shape.name == "long_500k":
        if cfg.is_encoder_decoder:
            return False, "enc-dec: encoder is quadratic in frames; decoder ctx bounded"
        sub_quadratic = cfg.attention_free or cfg.max_window > 0 or cfg.family == "hybrid"
        if not sub_quadratic:
            return False, "pure full-attention arch — long_500k skipped per assignment"
    return True, ""
