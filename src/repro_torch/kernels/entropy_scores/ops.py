"""Per-row predictive entropy and NLL of (B, V) logits: the port of the
reference's ``kernels.entropy_scores.ops.entropy_nll``, the fused pass of
the interestingness scorers (``core.interestingness``).

The device of the input decides what runs: a CUDA tensor launches the
hand-written kernel (``csrc/entropy_scores.cu``) or raises, a CPU tensor
runs the plain PyTorch version ``reference``. There is no switch between
the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

# kernel launches made by ``entropy_nll`` since the last reset (one a call:
# the call's two passes count as one launch of the kernel)
launches = 0

SMS = 132  # streaming multiprocessors of an H100 SXM
FILL = 2 * SMS  # pass-1 blocks that fill the card
MIN_WIDTH = 1024  # fewest columns a span takes (below it, one span a row)
ALIGN = 8  # span starts stay 16-byte aligned for float32 and bfloat16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(logits, labels) -> None:
    if logits.dim() != 2 or not logits.is_floating_point():
        raise ValueError(f"logits must be (B, V) floating point, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if labels.shape != logits.shape[:1]:
        raise ValueError(f"labels must be ({logits.shape[0]},), got "
                         f"{tuple(labels.shape)}")
    if labels.device != logits.device:
        raise ValueError("logits and labels must share a device")


def reference(logits, labels):
    """Plain PyTorch version, the reference's ``ref.entropy_nll``: in
    float32, entropy = −Σ p·log p with p = softmax(logits), nll =
    logsumexp(logits) − logits[label]."""
    _check(logits, labels)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    logp = logits - lse[:, None]
    p = torch.exp(logp)
    ent = -torch.sum(p * logp, dim=-1)
    gold = torch.gather(logits, 1, labels.to(torch.int64)[:, None])[:, 0]
    return ent, lse - gold


def split_columns(b: int, v: int) -> tuple[int, int]:
    """(splits, width): the kernel cuts each of the B rows of V columns
    into ``splits`` spans, span i covering [i·width, min((i+1)·width, V)),
    one block each. Enough spans that B·splits blocks fill the card, each
    at least ``MIN_WIDTH`` columns wide, and one span once B alone fills
    it; the width is a multiple of ``ALIGN`` and no span is empty."""
    want = max(1, min(-(-FILL // max(b, 1)), v // MIN_WIDTH))
    width = max(ALIGN, -(-v // want // ALIGN) * ALIGN)
    return max(1, -(-v // width)), width


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("entropy_scores").entropy_nll_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def entropy_nll(logits, labels):
    """logits (B, V) float32 or bfloat16 — labels (B,) integer in [0, V) →
    (entropy (B,), nll (B,)) float32, the kernel's entropy as
    lse − Σe^{l−m}·l / Σe^{l−m} (within 2e-5 of the plain version's
    −Σp·log p, not bitwise). The kernel runs in two passes over
    ``split_columns(B, V)`` spans of each row, merged in span order.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    global launches
    if logits.device.type == "cpu":
        return reference(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"no kernel for device {logits.device}")
    _check(logits, labels)
    if logits.dtype not in _DTYPES:
        raise ValueError(f"the kernel reads float32 or bfloat16 logits, not "
                         f"{logits.dtype}")
    logits = logits.contiguous()
    labels = labels.to(torch.int32).contiguous()
    b, v = logits.shape
    ent = torch.empty((b,), dtype=torch.float32, device=logits.device)
    nll = torch.empty((b,), dtype=torch.float32, device=logits.device)
    if b == 0:
        return ent, nll
    splits, width = split_columns(b, v)
    if b * splits >= 2**31:
        raise ValueError(f"the entropy_nll kernel takes fewer than 2^31 "
                         f"blocks, got {b} rows of {splits} spans")
    # the spans' (m, S, T) partials; freed on return, which is safe: the
    # caching allocator hands the block out again only in stream order
    part = torch.empty((b, splits, 3), dtype=torch.float32,
                       device=logits.device)
    per16 = 16 // logits.element_size()
    vec = int(v % per16 == 0 and logits.data_ptr() % 16 == 0)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(logits.data_ptr(), labels.data_ptr(), part.data_ptr(),
                        ent.data_ptr(), nll.data_ptr(), b, v, splits, width,
                        _DTYPES[logits.dtype], vec, stream)
    if err:
        raise RuntimeError(f"entropy_nll launch failed: CUDA error {err}")
    launches += 1
    return ent, nll
