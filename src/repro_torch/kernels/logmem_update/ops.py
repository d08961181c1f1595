"""Logmem admission scan: scores (M, N) and ids (M, N) against per-stream
acceptance thresholds tau (M,) → admit mask, and per-(stream, tile) admit
count, live count and live maximum.

``logmem_admit`` is the port of the reference's
``kernels.logmem_update.ops.logmem_admit``; the threshold epilogue that
consumes it lives in ``streams.logmem.update``. The device of the input
decides what runs: a CUDA tensor launches the hand-written kernel
(``csrc/logmem_update.cu``) or raises, a CPU tensor runs the plain
PyTorch version ``reference``. There is no switch between the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

PAD_ID = -1

# kernel launches made by ``logmem_admit`` since the last reset
launches = 0


def tile_width(n: int) -> int:
    """Columns per tile: the reference's ``min(block_n, max(n, 128))`` at
    its default ``block_n`` of 512."""
    return min(512, max(n, 128))


def _check(scores: torch.Tensor, ids: torch.Tensor,
           tau: torch.Tensor) -> None:
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be (M, N) float32, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if ids.shape != scores.shape or ids.dtype != torch.int32:
        raise ValueError(f"ids must be {tuple(scores.shape)} int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if tau.shape != scores.shape[:1] or tau.dtype != torch.float32:
        raise ValueError(f"tau must be ({scores.shape[0]},) float32, got "
                         f"{tuple(tau.shape)} {tau.dtype}")
    if not scores.device == ids.device == tau.device:
        raise ValueError("scores, ids and tau must share a device")


def reference(scores: torch.Tensor, ids: torch.Tensor, tau: torch.Tensor):
    """Plain PyTorch version, the reference's pad-then-scan: rows are
    padded with id -1 to a tile multiple; pad columns are not live, so
    they enter no output."""
    _check(scores, ids, tau)
    m, n = scores.shape
    bn = tile_width(n)
    pad = (-n) % bn
    sp = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    ip = torch.nn.functional.pad(ids, (0, pad), value=PAD_ID)
    live = ip >= 0
    hit = live & (sp > tau.reshape(m, 1))
    acounts = hit.reshape(m, -1, bn).sum(dim=2, dtype=torch.int32)
    lcounts = live.reshape(m, -1, bn).sum(dim=2, dtype=torch.int32)
    tmax = torch.where(live, sp, float("-inf")).reshape(m, -1, bn).amax(2)
    return hit[:, :n].to(torch.int8), acounts, lcounts, tmax


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("logmem_update").logmem_admit_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def logmem_admit(scores: torch.Tensor, ids: torch.Tensor, tau: torch.Tensor):
    """scores (M, N) float32 and ids (M, N) int32 (< 0 = padding) vs tau
    (M,) float32 → (mask (M, N) int8, admit_counts (M, tiles) int32,
    live_counts (M, tiles) int32, tile_max (M, tiles) float32), tiles of
    ``tile_width(N)`` columns. Padding is inert in every output, even
    under tau = -inf: the scan gates on ids, not on a score sentinel.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    global launches
    if scores.device.type == "cpu":
        return reference(scores, ids, tau)
    if scores.device.type != "cuda":
        raise ValueError(f"no kernel for device {scores.device}")
    _check(scores, ids, tau)
    if not (scores.is_contiguous() and ids.is_contiguous()
            and tau.is_contiguous()):
        raise ValueError("scores, ids and tau must be contiguous")
    m, n = scores.shape
    bn = tile_width(n)
    tiles = -(-n // bn)
    dev = scores.device
    mask = torch.empty((m, n), dtype=torch.int8, device=dev)
    acounts = torch.empty((m, tiles), dtype=torch.int32, device=dev)
    lcounts = torch.empty((m, tiles), dtype=torch.int32, device=dev)
    tmax = torch.empty((m, tiles), dtype=torch.float32, device=dev)
    if m * tiles == 0:
        return mask, acounts, lcounts, tmax
    # 16-byte loads need rows of whole float4s on 16-byte addresses
    vec = int(n % 4 == 0 and scores.data_ptr() % 16 == 0
              and ids.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(scores.data_ptr(), ids.data_ptr(), tau.data_ptr(),
                        mask.data_ptr(), acounts.data_ptr(),
                        lcounts.data_ptr(), tmax.data_ptr(), m, n, bn, tiles,
                        vec, stream)
    if err:
        raise RuntimeError(f"logmem_admit launch failed: CUDA error {err}")
    launches += 1
    return mask, acounts, lcounts, tmax
