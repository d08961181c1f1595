"""The fused plan-solve reduction: per stream, the feasible monotone
boundary tuple of least cost over S stacked tier subsets.

The port of the reference's ``kernels.plan_solve.ops`` (``enum_solve``'s
Pallas route) and of the body of ``plan_solve_pallas``. ``enum_solve``
builds the mask, lower-bound and latency-delta grids from the solver's
terms and hands them to ``plan_solve``. The device of the input decides
what runs there: a CUDA tensor launches one of the two hand-written
kernels of ``csrc/plan_solve.cu`` (``launch_plan`` picks it from the
shape) or raises, a CPU tensor runs the plain PyTorch version
``reference``. There is no switch between the two.

Semantics both versions keep, bit for bit:

- tuple terms are summed in step order from zero, then the subset's
  constants are added in order (``((interior + a) + b) + cc``);
- a tuple is infeasible (+inf) when masked and any step is masked out,
  a pairwise lower bound is violated (``prev < lb·(1 − 1e-12) − 1e-12``,
  each operation rounded on its own), or the summed latency deltas
  exceed ``rhs + atol``;
- the first minimum wins among a subset's tuples
  (``itertools.combinations_with_replacement`` order), a strict ``<``
  across subsets; a subset holding a NaN tuple is skipped whole, as the
  reference's NaN-propagating ``min`` makes it; an all-infeasible stream
  returns (+inf, 0).
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math

import numpy as np
import torch

from .. import build

MAX_CANDIDATES = 256  # the kernel keeps combo tables as uint8
MAX_CONSTS = 4  # per-subset addends the kernel holds in registers
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block may use
# from this many tuples a subset (or J > 3), one block per stream
# (plan_solve_streams); below it tiles of streams, a thread each
# (plan_solve_rows)
STREAMS_MIN_G = 64
ROW_TILE = 128  # plan_solve_rows' most streams (and threads) a block
MAX_THREADS = 256  # plan_solve_streams' largest block
TILE_BYTES = 16 * 1024  # staged rows a plan_solve_rows buffer aims at

# kernel launches made by ``plan_solve`` since the last reset
launches = 0


@functools.lru_cache(maxsize=None)
def monotone_combos(c: int, j: int) -> np.ndarray:
    """(G, J) int64 monotone index tuples over a C-candidate grid, in
    ``itertools.combinations_with_replacement`` (lexicographic) order:
    the host enum solver's tuple order, so argmin precedence agrees."""
    return np.asarray(
        list(itertools.combinations_with_replacement(range(c), j)),
        np.int64).reshape(-1, j)


def pair_lb_law(cval, cap_m, kf):
    """``BoundaryObjective.pair_lower_bound`` evaluated at candidate
    values ``cval`` (the reference's ``ref.pair_lb_law``)."""
    slack = 1.0 - cap_m / torch.minimum(cval, kf)
    lb = cval * torch.clamp_min(slack, 0.0)
    return torch.where(torch.isfinite(cap_m) & (cval > 0),
                       torch.nan_to_num(lb, nan=0.0, posinf=0.0), 0.0)


def _check(fs, const, combos, grids) -> None:
    if fs.dim() != 4 or fs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"fs must be (M, S, J, C) float32 or float64, got "
                         f"{tuple(fs.shape)} {fs.dtype}")
    m, s, j, c = fs.shape
    if const.shape[:2] != (m, s) or const.dim() != 3 or (
            const.dtype != fs.dtype) or not 1 <= const.shape[2] <= MAX_CONSTS:
        raise ValueError(f"const must be ({m}, {s}, P<={MAX_CONSTS}) "
                         f"{fs.dtype}, got {tuple(const.shape)} {const.dtype}")
    if combos.shape != (combos.shape[0], j) or combos.dtype != torch.uint8:
        raise ValueError(f"combos must be (G, {j}) uint8, got "
                         f"{tuple(combos.shape)} {combos.dtype}")
    if not 1 <= c <= MAX_CANDIDATES:
        raise ValueError(f"need 1 <= C <= {MAX_CANDIDATES}, got {c}")
    tensors = [fs, const, combos]
    if grids is not None:
        cand, mask, lb, deltas, rhs_atol = grids
        want = ((cand, (m, s, c), fs.dtype), (mask, (m, s, j, c), torch.bool),
                (lb, (m, s, max(j - 1, 1), c), fs.dtype),
                (deltas, (m, s, j, c), fs.dtype),
                (rhs_atol, (m, s, 2), fs.dtype))
        for x, shape, dtype in want:
            if tuple(x.shape) != shape or x.dtype != dtype:
                raise ValueError(f"grid must be {shape} {dtype}, got "
                                 f"{tuple(x.shape)} {x.dtype}")
        tensors += list(grids)
    if any(x.device != fs.device for x in tensors):
        raise ValueError("plan_solve's inputs must share a device")


def reference(fs, const, combos, grids=None):
    """Plain PyTorch version of ``plan_solve_pallas``'s body: gathers each
    step's term onto the (M, S, G) tuple grid instead of the TPU's one-hot
    matmuls, with the kernel's order of operations."""
    _check(fs, const, combos, grids)
    m, s, j_steps, _ = fs.shape
    cb = combos.long()
    g = cb.shape[0]
    tot = torch.zeros((m, s, g), dtype=fs.dtype, device=fs.device)
    for j in range(j_steps):
        tot = tot + fs[:, :, j, cb[:, j]]
    for p in range(const.shape[2]):
        tot = tot + const[:, :, p:p + 1]
    if grids is not None:
        cand, mask, lb, deltas, rhs_atol = grids
        bad = torch.zeros((m, s, g), dtype=torch.bool, device=fs.device)
        acc = torch.zeros_like(tot)
        for j in range(j_steps):
            bad |= ~mask[:, :, j, cb[:, j]]
            acc = acc + deltas[:, :, j, cb[:, j]]
        for j in range(1, j_steps):
            lbd = lb[:, :, j - 1, cb[:, j]]
            bad |= cand[:, :, cb[:, j - 1]] < lbd * (1 - 1e-12) - 1e-12
        budget = rhs_atol[:, :, 0] + rhs_atol[:, :, 1]
        bad |= acc > budget[:, :, None]
        tot = torch.where(bad, torch.inf, tot)
    vmin = tot.amin(dim=2)  # NaN wherever a subset holds a NaN tuple
    amin = tot.argmin(dim=2).to(torch.int32)  # first minimum
    val = torch.full((m,), torch.inf, dtype=fs.dtype, device=fs.device)
    idx = torch.zeros((m,), dtype=torch.int32, device=fs.device)
    for si in range(s):
        upd = vmin[:, si] < val  # strict: NaN rows never update
        val = torch.where(upd, vmin[:, si], val)
        idx = torch.where(upd, si * g + amin[:, si], idx)
    return val, idx


def _pad(n: int) -> int:
    """Elements between two streams' staged rows of ``n`` 4- or 8-byte
    elements: an odd number (``pad`` in csrc/plan_solve.cu)."""
    return n | 1


def _chunked(i, k, size):
    """Is input ``i`` (``k`` elements of ``size`` bytes a stream) staged by
    plan_solve_rows as 16-byte chunks, unpadded: the mask always, others
    when at most 4 threads of a warp, one stream each, would read one bank
    at once (``bank_ways`` in csrc/plan_solve.cu)?"""
    return i == 3 or math.gcd(k, 16 if size == 8 else 32) <= 4


def _parts(s, j, c, p, masked, itemsize):
    """(elements a stream, element bytes) of each input a block stages:
    fs, const and, when masked, cand, mask, lb, deltas and rhs_atol."""
    parts = [(s * j * c, itemsize), (s * p, itemsize)]
    if masked:
        parts += [(s * c, itemsize), (s * j * c, 1),
                  (s * max(j - 1, 1) * c, itemsize), (s * j * c, itemsize),
                  (s * 2, itemsize)]
    return parts


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _smem_bytes(n, s, j, c, g, p, masked, itemsize, mapping, nres=0):
    """Dynamic shared memory of a block of ``mapping`` that stages ``n``
    streams' rows: for "rows" two buffers, each input in chunks or padded
    rows (``_chunked``); for "streams" one buffer of aligned 16-byte
    chunks, the combo table and ``nres`` partial results. The total of
    ``layout`` in csrc/plan_solve.cu, which refuses a launch whose bytes
    differ."""
    rows = 0
    for i, (k, size) in enumerate(_parts(s, j, c, p, masked, itemsize)):
        if mapping == "rows" and not _chunked(i, k, size):  # padded rows
            rows += _align16(n * _pad(k) * size)
        else:  # the aligned 16-byte chunks that hold the span
            rows += _align16(n * k * size) + 16
    if mapping == "rows":
        return 2 * rows
    return (rows + _align16(g * j) + 16 + _align16(nres * itemsize)
            + _align16(nres * 4))


def launch_plan(fs, const, combos, grids=None):
    """How ``plan_solve`` launches its kernel for these inputs: (mapping,
    streams a block, threads a block, bytes of dynamic shared memory).
    ``mapping`` is "rows" (G < STREAMS_MIN_G and J <= 3: tiles of
    streams, a thread a stream walking its tuples as nested loops, each
    block double-buffering the tiles it walks) or "streams" (a block a
    stream, its threads striding the tuples of the combo table). Raises
    ValueError when a block's staged rows and combo table exceed a
    block's shared memory."""
    m, s, j, c = fs.shape
    g, p, masked = combos.shape[0], const.shape[2], grids is not None
    size = fs.element_size()
    if g >= STREAMS_MIN_G or j > 3:
        mapping, tile = "streams", 1
        threads = min(MAX_THREADS, -(-g // 32) * 32)
        nres = s * threads // 32
    else:
        mapping, nres = "rows", 0
        stream_bytes = sum(k * sz if _chunked(i, k, sz) else _pad(k) * sz
                           for i, (k, sz) in enumerate(
                               _parts(s, j, c, p, masked, size)))
        tile = min(m, ROW_TILE, TILE_BYTES // stream_bytes)
        tile = max(1, tile // 32 * 32 if tile >= 32 else tile)  # whole warps
        threads = -(-tile // 32) * 32
    smem = _smem_bytes(tile, s, j, c, g, p, masked, size, mapping, nres)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"plan_solve ({mapping}) needs {smem} bytes of shared memory "
            f"for M={m} S={s} J={j} C={c} G={g} {fs.dtype}"
            f"{' masked' if masked else ''}, more than a block's "
            f"{SMEM_LIMIT}")
    return mapping, tile, threads, smem


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    suffix = "f64" if dtype == torch.float64 else "f32"
    fn = getattr(build.library("plan_solve"), f"plan_solve_launch_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] + [
        ctypes.c_int] * 9 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan_solve(fs, const, combos, grids=None):
    """fs (M, S, J, C) per-step terms; const (M, S, P) per-subset addends;
    combos (G, J) uint8 monotone tuples; ``grids`` None (unmasked) or
    (cand (M, S, C), mask (M, S, J, C) bool, lb (M, S, max(J-1, 1), C),
    deltas (M, S, J, C), rhs_atol (M, S, 2)) → (val (M,), idx (M,) int32
    = s·G + g of the first minimum).

    CUDA tensors run a kernel (the mapping of ``launch_plan``), CPU
    tensors the plain version."""
    global launches
    if fs.device.type == "cpu":
        return reference(fs, const, combos, grids)
    if fs.device.type != "cuda":
        raise ValueError(f"no kernel for device {fs.device}")
    _check(fs, const, combos, grids)
    tensors = [fs, const, combos] + list(grids or ())
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("plan_solve's inputs must be contiguous")
    m, s, j, c = fs.shape
    g = combos.shape[0]
    if g < 1 or m >= 2 ** 31:
        raise ValueError(f"plan_solve needs G >= 1 tuples and M < 2^31 "
                         f"streams, got G={g}, M={m}")
    mapping, tile, threads, smem = launch_plan(fs, const, combos, grids)
    val = torch.empty((m,), dtype=fs.dtype, device=fs.device)
    idx = torch.empty((m,), dtype=torch.int32, device=fs.device)
    if m == 0:
        return val, idx
    cand, mask, lb, deltas, rhs_atol = grids or (None,) * 5
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(fs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(fs.dtype)(
            fs.data_ptr(), const.data_ptr(), ptr(cand), ptr(mask), ptr(lb),
            ptr(deltas), ptr(rhs_atol), combos.data_ptr(), val.data_ptr(),
            idx.data_ptr(), m, s, j, c, g, const.shape[2],
            int(grids is not None), int(mapping == "streams"), tile, threads,
            smem, stream)
    if err:
        raise RuntimeError(f"plan_solve launch failed: CUDA error {err}")
    launches += 1
    return val, idx


def solve_inputs(fs, consts, *, cand, kf=None, pair_caps=None, alpha=None,
                 rhs=None, atol=None, masks=None):
    """``plan_solve``'s inputs (fs, const, combos, grids) for one stacked
    run of S subsets, built as the reference's Pallas route builds them.
    ``fs`` (M, S, J, C) finite terms, ``consts`` ordered (M, S) addends
    (+inf = infeasible subset), ``cand`` (M, S, C) sorted candidate
    values; ``masks`` a length-J list of (M, S, C) bool or None;
    ``pair_caps`` a length-(J-1) list of (M, S) middle-tier capacities or
    None, with ``kf`` (M,); ``alpha`` (M, S, J), ``rhs`` and ``atol``
    (M, S) the latency budget. The grids exist only when one of masks,
    pair caps or budget is given."""
    m, s, j_steps, c = fs.shape
    dtype, dev = fs.dtype, fs.device
    combos = torch.as_tensor(monotone_combos(c, j_steps).astype(np.uint8),
                             device=dev)
    const = torch.stack(list(consts), dim=2).contiguous()
    grids = None
    if masks is not None or pair_caps is not None or alpha is not None:
        ones = torch.ones((m, s, c), dtype=torch.bool, device=dev)
        mask = torch.stack([ones if mk is None else mk
                            for mk in (masks or [None] * j_steps)], dim=2)
        lb = torch.zeros((m, s, max(j_steps - 1, 1), c), dtype=dtype,
                         device=dev)
        if pair_caps is not None:
            lb = torch.stack(
                [torch.zeros((m, s, c), dtype=dtype, device=dev)
                 if cap_m is None else
                 pair_lb_law(cand, cap_m[:, :, None], kf[:, None, None])
                 for cap_m in pair_caps], dim=2)
        if alpha is not None:
            deltas = cand[:, :, None, :] * alpha[:, :, :, None]
            rhs_atol = torch.stack([rhs, atol], dim=2)
        else:
            deltas = torch.zeros((m, s, j_steps, c), dtype=dtype, device=dev)
            rhs_atol = torch.stack(
                [torch.full((m, s), torch.inf, dtype=dtype, device=dev),
                 torch.zeros((m, s), dtype=dtype, device=dev)], dim=2)
        grids = tuple(x.contiguous()
                      for x in (cand, mask, lb, deltas, rhs_atol))
    return fs.contiguous(), const, combos, grids


def enum_solve(fs, consts, **kw):
    """Joint masked argmin over one stacked run of S subsets — the
    reference's ``ops.enum_solve`` with its kernel route (arguments as
    ``solve_inputs``). Returns (val (M,), s_idx (M,), sel (M, J) int32
    candidate indices)."""
    fs, const, combos, grids = solve_inputs(fs, consts, **kw)
    val, idx = plan_solve(fs, const, combos, grids)
    g = combos.shape[0]
    s_idx = torch.div(idx, g, rounding_mode="floor")
    sel = combos.to(torch.int32)[(idx % g).long()]
    return val, s_idx, sel
