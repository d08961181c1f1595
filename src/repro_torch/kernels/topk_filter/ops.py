"""One-stream threshold scan: scores (N,) against a scalar threshold →
survivor mask, and per-tile survivor count and maximum; and
``filter_then_merge``, the batched reservoir update built on it.

``topk_filter`` is the port of the reference's
``kernels.topk_filter.ops.topk_filter``. The device of the input decides
what runs: a CUDA tensor launches the hand-written kernel
(``csrc/topk_filter.cu``) or raises, a CPU tensor runs the plain PyTorch
version ``reference``. There is no switch between the two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import topk

from .. import build

NEG_BIG = -1e30

# kernel launches made by ``topk_filter`` since the last reset
launches = 0


def tile_width(n: int) -> int:
    """Columns per tile: the reference's ``min(block_n, max(n, 128))`` at
    its default ``block_n`` of 4096."""
    return min(4096, max(n, 128))


def _check(scores: torch.Tensor, threshold: torch.Tensor) -> None:
    if scores.dim() != 1 or not scores.is_floating_point():
        raise ValueError(f"scores must be (N,) floating point, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if threshold.numel() != 1 or not threshold.is_floating_point():
        raise ValueError(f"threshold must be a floating-point scalar, got "
                         f"{tuple(threshold.shape)} {threshold.dtype}")
    if threshold.device != scores.device:
        raise ValueError("scores and threshold must share a device")


def reference(scores: torch.Tensor, threshold: torch.Tensor):
    """Plain PyTorch version, the reference's pad-then-scan: scores cast
    to float32, padded with NEG_BIG to a tile multiple, NaN demoted to
    NEG_BIG; pad columns count toward the last tile's count and max and
    are stripped from the mask."""
    _check(scores, threshold)
    n = scores.shape[0]
    bn = tile_width(n)
    sp = torch.nn.functional.pad(scores.to(torch.float32), (0, (-n) % bn),
                                 value=NEG_BIG)
    sp = torch.where(torch.isnan(sp), NEG_BIG, sp)
    hit = sp > threshold.to(torch.float32).reshape(())
    counts = hit.reshape(-1, bn).sum(dim=1, dtype=torch.int32)
    return hit[:n].to(torch.int8), counts, sp.reshape(-1, bn).amax(dim=1)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("topk_filter").topk_filter_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def topk_filter(scores: torch.Tensor, threshold: torch.Tensor):
    """scores (N,) of any float dtype (cast to float32) vs a scalar
    threshold tensor → (mask (N,) int8, counts (tiles,) int32, tile_max
    (tiles,) float32), tiles of ``tile_width(N)`` columns. NaN scores
    count as NEG_BIG. The last tile's pad columns (NEG_BIG) are counted
    where the threshold is below NEG_BIG and enter its max, as in the
    reference.

    CUDA tensors run the kernel, CPU tensors the plain version."""
    global launches
    if scores.device.type == "cpu":
        return reference(scores, threshold)
    if scores.device.type != "cuda":
        raise ValueError(f"no kernel for device {scores.device}")
    _check(scores, threshold)
    scores = scores.to(torch.float32).contiguous()
    thr = threshold.to(torch.float32).reshape(1).contiguous()
    n = scores.shape[0]
    bn = tile_width(n)
    tiles = -(-n // bn)
    dev = scores.device
    mask = torch.empty((n,), dtype=torch.int8, device=dev)
    counts = torch.empty((tiles,), dtype=torch.int32, device=dev)
    tmax = torch.empty((tiles,), dtype=torch.float32, device=dev)
    if tiles == 0:
        return mask, counts, tmax
    vec = int(n % 4 == 0 and scores.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(scores.data_ptr(), thr.data_ptr(), mask.data_ptr(),
                        counts.data_ptr(), tmax.data_ptr(), n, bn, tiles,
                        vec, stream)
    if err:
        raise RuntimeError(f"topk_filter launch failed: CUDA error {err}")
    launches += 1
    return mask, counts, tmax


def filter_then_merge(state: topk.ReservoirState, scores: torch.Tensor,
                      ids: torch.Tensor):
    """Batched single-stream reservoir update for large score batches:
    filter the batch against the current bar with ``topk_filter``, then
    merge only the top min(K, N) survivors exactly (``topk.update``).
    Returns (new_state, wrote) with ``wrote`` over those survivors, as
    the reference does.

    As in the reference, survivors whose score is not finite (+inf, or
    the -inf of a filtered-out slot) enter the merge with id
    -(2**31) + 1, and ``seen`` advances by min(K, N)."""
    k = state.scores.shape[0]
    thr = state.scores[-1]  # -inf while unfull: everything passes
    mask, _, _ = topk_filter(scores, thr)
    surv = torch.where(mask > 0, scores.to(torch.float32), float("-inf"))
    top_idx = topk.top_k_positions(surv, min(k, scores.shape[0]))
    top_scores = surv[top_idx]
    top_ids = torch.where(torch.isfinite(top_scores), ids[top_idx], -1)
    return topk.update(state, top_scores,
                       torch.where(top_ids >= 0, top_ids, -(2 ** 31) + 1))
