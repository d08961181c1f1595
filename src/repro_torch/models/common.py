"""Shared model ops: norms, RoPE, initializers, dtype policy — the port of
the reference's ``models.common``. Initializers draw from an explicit
``torch.Generator`` (the same distributions as the reference's
``jax.random`` draws, not the same numbers)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def init_dense(gen: torch.Generator, shape, in_axes=(0,), dtype=torch.float32,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init on ``gen``'s device: a standard normal
    truncated to ±2, times scale/√fan_in; ``in_axes`` are the contracted
    dims."""
    fan_in = int(np.prod([shape[a] for a in in_axes]))
    out = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(scale / math.sqrt(fan_in)).to(dtype)  # in place: no copy


def rmsnorm(x, scale, eps):
    """Scales by (1 + scale): the scale parameter starts at zeros."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def norm_params(d, use_layernorm=False, dtype=torch.float32, device=None):
    if use_layernorm:
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p, x, eps, use_layernorm=False):
    if use_layernorm:
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates
    the split halves (x1, x2) of the head dim."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, d_model: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Whisper-style sinusoidal positional table (S, D) in float32, then
    ``dtype``: [sin | cos] concatenated (not interleaved) over the
    inverse frequencies exp(-i · ln 10000 / max(D/2 − 1, 1))."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    inv = torch.exp(-dim * (math.log(10000.0) / max(d_model // 2 - 1, 1)))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "silu_glu": ("glu", F.silu),
    "gelu_glu": ("glu", gelu),
    "gelu": ("plain", gelu),
    "silu": ("plain", F.silu),
}
