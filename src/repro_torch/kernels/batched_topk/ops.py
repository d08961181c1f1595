"""Fleet bar scan: scores (M, N) against per-stream bars (M,) → survivor
mask, and per-(stream, tile) survivor count and maximum.

``batched_topk_filter`` is the port of the reference's
``kernels.batched_topk.ops.batched_topk_filter``. The device of the input
decides what runs: a CUDA tensor launches one of the hand-written
kernels of ``csrc/batched_topk.cu`` (``launch_plan`` picks it from the
shape and the alignment) or raises, a CPU tensor runs the plain PyTorch
version ``reference``. There is no switch between the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..tile_max import tile_max

NEG_BIG = -1e30
NARROW = 32  # widest row scan_narrow gives to a single thread
# the kernel ids of csrc/batched_topk.cu
KERNELS = {"scan_narrow": 0, "scan_wide": 1, "scan_vec": 2}

# kernel launches made by ``batched_topk_filter`` since the last reset
launches = 0


def tile_width(n: int) -> int:
    """Columns per tile: the reference's ``min(block_n, max(n, 128))`` at
    its default ``block_n`` of 512."""
    return min(512, max(n, 128))


def _check(scores: torch.Tensor, bars: torch.Tensor) -> None:
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be (M, N) float32, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if bars.shape != scores.shape[:1] or bars.dtype != torch.float32:
        raise ValueError(f"bars must be ({scores.shape[0]},) float32, got "
                         f"{tuple(bars.shape)} {bars.dtype}")
    if bars.device != scores.device:
        raise ValueError("scores and bars must share a device")


def reference(scores: torch.Tensor, bars: torch.Tensor):
    """Plain PyTorch version, the reference's pad-then-scan: columns are
    padded with NEG_BIG to a tile multiple, pad columns count toward each
    tile's count and max and are stripped from the mask. A tile max of
    zero is +0.0 if the tile holds a +0.0 (``tile_max``)."""
    _check(scores, bars)
    m, n = scores.shape
    bn = tile_width(n)
    pad = (-n) % bn
    sp = torch.nn.functional.pad(scores, (0, pad), value=NEG_BIG)
    thr = bars.reshape(m, 1)
    hit = sp > thr
    tiles = sp.reshape(m, -1, bn)
    counts = hit.reshape(m, -1, bn).sum(dim=2, dtype=torch.int32)
    tmax = tile_max(tiles, 2)
    return hit[:, :n].to(torch.int8), counts, tmax


def launch_plan(scores: torch.Tensor, bars: torch.Tensor):
    """(kernel, lanes a row) that ``batched_topk_filter`` launches for
    ``scores`` (M, N) and ``bars`` (M,): "scan_vec" (a group of N/4 lanes
    a row, one 16-byte load a lane) when the row is one tile of N = 4G
    scores, G a power of two up to 32, and the base is 16-byte aligned;
    else "scan_narrow" (a thread a row) for one tile of at most NARROW
    scores; else "scan_wide" (a warp a tile). Raises ValueError unless
    both are contiguous."""
    if not (scores.is_contiguous() and bars.is_contiguous()):
        raise ValueError("scores and bars must be contiguous")
    n = scores.shape[1]
    single = n <= tile_width(n)
    lanes = n // 4
    if (single and n % 4 == 0 and 1 <= lanes <= 32
            and lanes & (lanes - 1) == 0 and scores.data_ptr() % 16 == 0):
        return "scan_vec", lanes
    if single and n <= NARROW:
        return "scan_narrow", 1
    return "scan_wide", 32


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("batched_topk").batched_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_topk_filter(scores: torch.Tensor, bars: torch.Tensor):
    """scores (M, N) float32 vs bars (M,) float32 → (mask (M, N) int8,
    counts (M, tiles) int32, tile_max (M, tiles) float32), tiles of
    ``tile_width(N)`` columns. Pad columns (NEG_BIG) of the last
    tile are counted where the bar is below NEG_BIG (an unfull reservoir,
    bar = -inf) and enter its max, as in the reference.

    CUDA tensors run the kernel ``launch_plan`` names, CPU tensors the
    plain version."""
    global launches
    if scores.device.type == "cpu":
        return reference(scores, bars)
    if scores.device.type != "cuda":
        raise ValueError(f"no kernel for device {scores.device}")
    _check(scores, bars)
    kernel, lanes = launch_plan(scores, bars)
    m, n = scores.shape
    bn = tile_width(n)
    tiles = -(-n // bn)
    mask = torch.empty((m, n), dtype=torch.int8, device=scores.device)
    counts = torch.empty((m, tiles), dtype=torch.int32, device=scores.device)
    tmax = torch.empty((m, tiles), dtype=torch.float32, device=scores.device)
    if m * tiles == 0:
        return mask, counts, tmax
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(scores.data_ptr(), bars.data_ptr(),
                        mask.data_ptr(), counts.data_ptr(), tmax.data_ptr(),
                        m, n, bn, tiles, KERNELS[kernel], lanes, stream)
    if err:
        raise RuntimeError(f"batched_topk launch failed: CUDA error {err}")
    launches += 1
    return mask, counts, tmax
