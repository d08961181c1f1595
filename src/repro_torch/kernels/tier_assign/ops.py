"""Finalize-time tier assignment: survivor ids (M, K) against per-stream
integer boundaries (M, B) and cascade floors (M,) → tier per survivor
(M, K) and survivors per tier (M, T).

The port of the reference's ``kernels.tier_assign.ops``. Boundaries are
quantized on the host once (``quantize_boundaries``, float64 as in the
reference) and the wrapper takes the int32 result, so a caller whose
boundaries do not change moves them to the card once. The device of the
input decides what runs: a CUDA tensor launches one of the hand-written
kernels of ``csrc/tier_assign.cu`` (``launch_plan`` picks it from the
shape and the alignment) or raises, a CPU tensor runs the plain PyTorch
version ``reference``. There is no switch between the two.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import build

_INT_MAX = np.iinfo(np.int32).max
MAX_TIERS = 8  # the planner's limit; the kernel keeps counts in registers
NARROW = 32  # widest row assign_narrow gives to a single thread
# the kernel ids of csrc/tier_assign.cu
KERNELS = {"assign_narrow": 0, "assign_wide": 1, "assign_vec": 2}

# kernel launches made by ``tier_assign`` since the last reset
launches = 0


def quantize_boundaries(bounds) -> np.ndarray:
    """(M, B) float boundary vectors -> exact int32 thresholds: survivor
    ids are integers, so ``id >= b`` is exactly ``id >= ceil(b)``; +inf
    (the padding of shallower streams) maps to INT32_MAX."""
    b = np.asarray(bounds, np.float64)
    return np.where(np.isfinite(b),
                    np.clip(np.ceil(b), 0, _INT_MAX), _INT_MAX
                    ).astype(np.int32)


def _check(ids, bounds_int, floor, n_tiers) -> None:
    if (ids.dim(), bounds_int.dim(), floor.dim()) != (2, 2, 1) or not (
            ids.shape[0] == bounds_int.shape[0] == floor.shape[0]):
        raise ValueError(f"need ids (M, K), bounds_int (M, B), floor (M,); "
                         f"got {tuple(ids.shape)}, {tuple(bounds_int.shape)}"
                         f", {tuple(floor.shape)}")
    if any(x.dtype != torch.int32 for x in (ids, bounds_int, floor)):
        raise ValueError("ids, bounds_int and floor must be int32")
    if not ids.device == bounds_int.device == floor.device:
        raise ValueError("ids, bounds_int and floor must share a device")
    if not 1 <= n_tiers <= MAX_TIERS or bounds_int.shape[1] >= MAX_TIERS:
        raise ValueError(f"need 1 <= n_tiers <= {MAX_TIERS} and at most "
                         f"{MAX_TIERS - 1} boundaries")


def reference(ids: torch.Tensor, bounds_int: torch.Tensor,
              floor: torch.Tensor, n_tiers: int):
    """Plain PyTorch version (the reference's ``ref.tier_assign``)."""
    _check(ids, bounds_int, floor, n_tiers)
    valid = ids >= 0
    tier = (ids[:, :, None] >= bounds_int[:, None, :]).sum(-1,
                                                           dtype=torch.int32)
    tier = torch.maximum(tier, floor[:, None]).clamp_(max=n_tiers - 1)
    tier = torch.where(valid, tier, -1)
    levels = torch.arange(n_tiers, dtype=torch.int32, device=ids.device)
    one_hot = (tier[:, :, None] == levels) & valid[:, :, None]
    return tier, one_hot.sum(dim=1, dtype=torch.int32)


def launch_plan(ids: torch.Tensor, bounds_int: torch.Tensor,
                floor: torch.Tensor):
    """(kernel, lanes a row) that ``tier_assign`` launches for ``ids``
    (M, K), ``bounds_int`` (M, B) and ``floor`` (M,): "assign_vec" (a
    group of K/4 lanes a row, one 16-byte load and store a lane) when
    K = 4G, G a power of two up to 32, and the ids' base is 16-byte
    aligned; else "assign_narrow" (a thread a row) for at most NARROW ids;
    else "assign_wide" (a warp a row). Raises ValueError unless all three
    are contiguous."""
    if not (ids.is_contiguous() and bounds_int.is_contiguous()
            and floor.is_contiguous()):
        raise ValueError("ids, bounds_int and floor must be contiguous")
    k = ids.shape[1]
    lanes = k // 4
    if (k % 4 == 0 and 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
            and ids.data_ptr() % 16 == 0):
        return "assign_vec", lanes
    if k <= NARROW:
        return "assign_narrow", 1
    return "assign_wide", 32


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("tier_assign").tier_assign_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tier_assign(ids: torch.Tensor, bounds_int: torch.Tensor,
                floor: torch.Tensor, *, n_tiers: int | None = None):
    """ids (M, K) int32 (-1 = padding), bounds_int (M, B) int32 from
    ``quantize_boundaries``, floor (M,) int32 → (tier (M, K) int32 with
    -1 at padding, counts (M, T) int32 survivors per tier). T defaults to
    B + 1.

    CUDA tensors run the kernel ``launch_plan`` names, CPU tensors the
    plain version."""
    global launches
    t = int(n_tiers) if n_tiers is not None else bounds_int.shape[1] + 1
    if ids.device.type == "cpu":
        return reference(ids, bounds_int, floor, t)
    if ids.device.type != "cuda":
        raise ValueError(f"no kernel for device {ids.device}")
    _check(ids, bounds_int, floor, t)
    kernel, lanes = launch_plan(ids, bounds_int, floor)
    m, k = ids.shape
    tier = torch.empty((m, k), dtype=torch.int32, device=ids.device)
    counts = torch.empty((m, t), dtype=torch.int32, device=ids.device)
    if m == 0:
        return tier, counts
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(ids.data_ptr(), bounds_int.data_ptr(),
                        floor.data_ptr(), tier.data_ptr(), counts.data_ptr(),
                        m, k, bounds_int.shape[1], t, KERNELS[kernel], lanes,
                        stream)
    if err:
        raise RuntimeError(f"tier_assign launch failed: CUDA error {err}")
    launches += 1
    return tier, counts
