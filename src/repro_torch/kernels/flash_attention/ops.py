"""Forward attention with online softmax: the port of the reference's
``kernels.flash_attention.ops.flash_attention``, with grouped KV heads.

q is (B, Sq, H, hd), k and v are (B, Skv, KV, hd) with KV | H: query head
h reads KV head h // (H / KV), and the expanded K/V never exist. With
KV = H it is the reference's function. Query row i sits at position
i + Skv − Sq and key j at position j; causal and sliding-window masks
(``kpos > qpos − window``) come from those positions and use the
reference's −2e9.

The device of the input decides what runs: a CUDA tensor launches the
hand-written kernel (``csrc/flash_attention.cu``) or raises, a CPU tensor
runs the plain PyTorch version ``reference``. There is no switch between
the two.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import build

NEG = -2.0e9  # the reference's mask value
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is compiled for
ROWS = 64  # the fewest query rows a block of the kernel takes
MAX_GRID = 65535  # the kernel's grid: batch and Sq / ROWS each up to this

# kernel launches made by ``flash_attention`` since the last reset
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, head_dim)")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{k.shape[2]} KV heads do not divide {h} heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")


def reference(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """Plain PyTorch version, the reference's ``ref.flash_attention``:
    float32 logits scaled after the product, masked with −2e9, softmax,
    float32 product with v, cast to q's dtype; KV heads mapped to query
    heads by repetition."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = scale or 1.0 / math.sqrt(hd)
    g = h // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * scale
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    kpos = torch.arange(skv, device=q.device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(ok[None, None], logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q (B, Sq, H, hd), k and v (B, Skv, KV, hd), float32 or bfloat16 →
    (B, Sq, H, hd) in q's dtype. ``scale`` defaults to 1/√hd (0 counts as
    unset, as in the reference). A row whose keys are all masked averages
    v over all Skv keys, as the reference's plain version does.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    global launches
    if q.device.type == "cpu":
        return reference(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"the flash_attention kernel is built for "
                                  f"head dims {HEAD_DIMS}, not {hd}")
    if b > MAX_GRID or -(-sq // ROWS) > MAX_GRID:
        raise ValueError(f"the flash_attention kernel takes a batch and "
                         f"Sq / {ROWS} up to {MAX_GRID}, got {b} and {sq}")
    scale = scale or 1.0 / math.sqrt(hd)
    # the kernel copies 16-byte pieces of rows: contiguous, aligned
    q, k, v = (x.contiguous() for x in (q, k, v))
    q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, sq, skv, h, kvh, hd, scale,
                        int(causal), int(window), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
