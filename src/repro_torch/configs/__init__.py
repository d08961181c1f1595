"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``. The
ten architecture files are copies of the reference's, as data."""
from __future__ import annotations

from . import (base, command_r_plus_104b, deepseek_v2_236b, grok_1_314b,
               hymba_1_5b, llama3_2_1b, mamba2_2_7b, pixtral_12b,
               starcoder2_3b, whisper_base, yi_9b)
from .base import SHAPES, LayerSpec, ModelConfig, ShapeConfig, supports_shape  # noqa: F401

_MODULES = (
    hymba_1_5b, mamba2_2_7b, deepseek_v2_236b, grok_1_314b, pixtral_12b,
    llama3_2_1b, yi_9b, starcoder2_3b, command_r_plus_104b, whisper_base,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {list(ARCHS)}")
    m = ARCHS[arch_id]
    return m.reduced() if reduced else m.full()


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {list(SHAPES)}")
    return SHAPES[name]
