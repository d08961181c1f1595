"""repro_torch on a CUDA card: each hand-written kernel against its plain
PyTorch version, and the engine on the card against the engine on the
CPU (double-buffered ingest of exact and logmem buckets, finalize_tiers,
launch counters), ``filter_then_merge`` on the card against the CPU,
the device planner on the card against the NumPy oracle, and the serve
loop on the card (flash_attention and entropy_scores) against the CPU.
Every test here is marked ``cuda`` and skips without a card.

The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Its input-case helpers are shared with the CPU parity tests
(tests/test_torch_kernels.py, tests/test_torch_engine.py,
tests/test_torch_logmem.py, tests/test_torch_topk_filter.py,
tests/test_torch_plan_solve.py).

Tolerance: exact — integer outputs, maxima that are input elements, and
plan_solve's minima, which both versions reach by the same adds in the
same order (also at the online re-solve's four-tier inputs, whose terms
carry +inf). The re-solve and the re-planning engine on the card are
held to the CPU with bounds, drift leaves and decisions equal and
suffix costs within 1e-11 relative (a float64 log may round differently
on the two devices). The planner on the card is held to the oracle with the
reference's own tolerances (float64: 1e-11 relative on totals).
flash_attention and entropy_nll sum in another order than their plain
versions: 2e-5 in float32 and 2e-2 in bfloat16 (the reference's
tolerances for its kernels), and serve's scores within 2e-5.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import constraints as t_cons
from repro_torch.core import costs as t_costs
from repro_torch.core import placement as t_place
from repro_torch.core import shp as t_shp
from repro_torch.core import shp_device as t_dev
from repro_torch.core import simulator as t_sim
from repro_torch.core import topk as t_topk
from repro_torch.core import topology as t_topo
from repro_torch import configs as t_configs
from repro_torch.kernels.batched_topk import ops as t_btk
from repro_torch.kernels.entropy_scores import ops as t_ent
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.logmem_update import ops as t_lm_ops
from repro_torch.kernels.plan_solve import ops as t_ps
from repro_torch.kernels.tier_assign import ops as t_ta
from repro_torch.kernels.topk_filter import ops as t_tf
from repro_torch.launch import serve as t_serve
from repro_torch.models import lm as t_lm
from repro_torch.online import drift as t_drift
from repro_torch.online import replan as t_replan
from repro_torch.online import replan_device as t_rd
from repro_torch.streams import engine as t_eng

METER_FIELDS = ("observed", "writes", "reads", "deletes", "migrations",
                "floor", "occupancy", "occupancy_hwm", "doc_steps",
                "mig_reads", "mig_writes", "boundaries", "migrate")


def btk_case(m, n, seed):
    """Scores with ties and bars of every kind: -inf (unfull reservoir,
    pad columns counted), bars equal to a score, ordinary bars."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((m, n)).astype(np.float32)
    scores[:, ::5] = 0.5
    bars = rng.uniform(-1, 1, m).astype(np.float32)
    bars[0] = -np.inf
    if m > 1:
        bars[1] = 0.5
    if m > 2:
        bars[2] = scores[2, n // 2]
    return scores, bars


# widths under one tile (7, 16: pad columns counted arithmetically), one
# full tile (128, 500), and several tiles of 512 with a padded last one
BTK_CASES = [(1, 128), (3, 500), (5, 16), (4, 7), (3, 600), (2, 1024),
             (2, 1300)]


def ta_case(m, k, b, seed):
    """Ids with -1 pads, fractional and ±inf boundaries, cascade floors."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (m, k)).astype(np.int32)
    ids[rng.random((m, k)) < 0.2] = -1
    bounds = np.sort(rng.uniform(0, 1000, (m, b)), axis=1)
    bounds[0, -1] = np.inf
    bounds[-1, 0] = -np.inf
    if b > 1:
        bounds[m // 2, 1:] = bounds[m // 2, :1]  # collapsed middle tiers
    floor = rng.integers(0, b + 1, m).astype(np.int32)
    return ids, bounds, floor


TA_CASES = [(1, 128, 1), (5, 64, 2), (16, 33, 3), (3, 7, 4), (4, 8, 2),
            (2, 5, 7)]

INT32_MAX = np.iinfo(np.int32).max


def btk_seam_case(m, n, kind, seed):
    """``btk_case``'s scores and bars, then by ``kind``: "nan" (NaN scores
    in some rows, NaN bars in others), "zeros" (scores of -0.0 and +0.0
    and bars of -0.0 and +0.0), "ninf" (every bar -inf: pad columns
    counted), "plain" (as they are)."""
    scores, bars = btk_case(m, n, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "nan":
        scores[rng.random((m, n)) < 0.05] = np.nan
        bars[rng.random(m) < 0.2] = np.nan
        scores[-1, 0] = np.nan
    elif kind == "zeros":
        zeros = np.array([-0.0, 0.0], np.float32)
        hit = rng.random((m, n)) < 0.4
        scores[hit] = zeros[rng.integers(0, 2, int(hit.sum()))]
        bars = zeros[rng.integers(0, 2, m)]
    elif kind == "ninf":
        bars[:] = -np.inf
    return scores, bars


# (M, N, kind, view 4 bytes off 16-byte alignment, kernel launch_plan
# picks): rows ending inside a warp and a block at the main width N = 16,
# the other widths the vector kernel takes (4 to 128) and ones it
# refuses (12, 7), misaligned views, NaN, signed zeros and -inf bars
BTK_SEAM_CASES = [
    (1, 16, "ninf", False, "scan_vec"), (7, 16, "nan", False, "scan_vec"),
    (9, 16, "zeros", False, "scan_vec"), (33, 16, "plain", False, "scan_vec"),
    (4097, 16, "nan", False, "scan_vec"),
    (4097, 16, "ninf", False, "scan_vec"),
    (33, 4, "nan", False, "scan_vec"), (9, 8, "zeros", False, "scan_vec"),
    (33, 32, "ninf", False, "scan_vec"), (9, 64, "nan", False, "scan_vec"),
    (7, 128, "zeros", False, "scan_vec"),
    (33, 12, "nan", False, "scan_narrow"),
    (9, 7, "zeros", False, "scan_narrow"),
    (4097, 16, "nan", True, "scan_narrow"),
    (9, 16, "ninf", True, "scan_narrow"),
    (9, 64, "zeros", True, "scan_wide"), (5, 600, "nan", False, "scan_wide")]


def ta_edge_case(m, k, b, t, seed):
    """Tier-assignment inputs at the edges, T tiers over B boundaries:
    ids equal to a boundary, ids of INT32_MAX - 1 (and a boundary there in
    the middle row), -1 and other negative pads, +inf boundaries, floors
    of T - 1 in every third row."""
    rng = np.random.default_rng(seed)
    bounds = np.sort(rng.integers(0, 1000, (m, b)), axis=1).astype(float)
    ids = rng.integers(0, 1000, (m, k))
    if b:
        bounds[::4, -1] = np.inf
        bounds[m // 2, -1] = INT32_MAX - 1
        col = np.minimum(rng.integers(0, b, (m, k)), b - 1)
        at = (rng.random((m, k)) < 0.4) & np.isfinite(
            np.take_along_axis(bounds, col, 1))
        ids[at] = np.take_along_axis(bounds, col, 1)[at]
    ids[rng.random((m, k)) < 0.1] = INT32_MAX - 1
    ids[m // 2, 0] = INT32_MAX - 1
    ids[rng.random((m, k)) < 0.15] = -1
    ids[rng.random((m, k)) < 0.03] = -7
    floor = rng.integers(0, t, m)
    floor[::3] = t - 1
    return ids.astype(np.int32), bounds, floor.astype(np.int32)


# (M, K, B, T, view 4 bytes off 16-byte alignment, kernel launch_plan
# picks): rows ending inside a warp and a block at the main K = 8, B = 2,
# T = 3, T from 1 to 8 (below, at and above B + 1), the other widths the
# vector kernel takes (4 to 128) and ones it refuses (6, 5), misaligned
# views
TA_SEAM_CASES = [
    (1, 8, 2, 3, False, "assign_vec"), (7, 8, 2, 3, False, "assign_vec"),
    (9, 8, 2, 3, False, "assign_vec"), (33, 8, 2, 3, False, "assign_vec"),
    (4097, 8, 2, 3, False, "assign_vec"),
    (33, 8, 2, 1, False, "assign_vec"), (33, 8, 1, 2, False, "assign_vec"),
    (9, 8, 3, 4, False, "assign_vec"), (9, 8, 2, 5, False, "assign_vec"),
    (9, 8, 5, 6, False, "assign_vec"), (9, 8, 6, 7, False, "assign_vec"),
    (9, 8, 7, 8, False, "assign_vec"), (9, 8, 7, 3, False, "assign_vec"),
    (33, 4, 2, 3, False, "assign_vec"), (9, 16, 3, 4, False, "assign_vec"),
    (9, 64, 2, 3, False, "assign_vec"), (5, 128, 7, 8, False, "assign_vec"),
    (33, 6, 2, 3, False, "assign_narrow"),
    (9, 5, 3, 4, False, "assign_narrow"),
    (4097, 8, 2, 3, True, "assign_narrow"),
    (9, 64, 2, 3, True, "assign_wide"), (3, 40, 2, 3, False, "assign_wide")]


def offset_view(x):
    """A contiguous copy of ``x`` that starts 4 bytes into its storage, so
    its base is off 16-byte alignment."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def same_exactly(outs, refs):
    """Equal outputs, NaN where the plain version has NaN (signed zeros
    compare equal, as in the reference's own tests)."""
    for a, r in zip(outs, refs):
        assert a.shape == r.shape and a.dtype == r.dtype
        torch.testing.assert_close(a, r, rtol=0, atol=0, equal_nan=True)


TIED_POOL = np.array([-1.0, -0.0, 0.0, 0.5, 0.5, 1.0, 2.0], np.float32)


def tied_scores(rng, shape):
    """Half the entries from a small pool (ties, both signed zeros), half
    standard normal."""
    return np.where(rng.random(shape) < 0.5,
                    TIED_POOL[rng.integers(0, TIED_POOL.size, shape)],
                    rng.standard_normal(shape)).astype(np.float32)


def lm_admit_case(m, n, seed):
    """Logmem admission inputs: tied scores, pad ids between live ones
    (with finite pad scores), an all-pad row, thresholds of -inf, equal
    to a score, and ordinary."""
    rng = np.random.default_rng(seed)
    scores = tied_scores(rng, (m, n))
    ids = np.tile(np.arange(n, dtype=np.int32), (m, 1))
    ids[rng.random((m, n)) < 0.15] = -1
    tau = rng.uniform(-1, 1, m).astype(np.float32)
    tau[0] = -np.inf
    if m > 1:
        ids[1] = -1
        tau[1] = -np.inf
    if m > 2:
        tau[2] = 0.5
    return scores, ids, tau


# (M, N): one thread per row (N <= 32), one warp per tile with and
# without 16-byte loads (N % 4), partial last tiles, the deployment chunk
LM_CASES = [(5, 40), (3, 512), (4, 600), (2, 1024), (3, 1500), (6, 7),
            (40, 16), (64, 8192), (3, 8190)]


def lm_seam_case(m, n, kind, seed):
    """``lm_admit_case``'s inputs, then by ``kind``: "nan" (NaN scores
    among live entries, NaN thresholds in some rows), "zeros" (every other
    row's scores made non-positive, then -0.0 and +0.0 sprinkled in, so
    tiles whose largest live scores are signed zeros, against thresholds
    of -0.0 and +0.0), "padtile" (the second tile of every row all pad: a
    tile without a live entry inside a live row), "plain" (as they
    are)."""
    scores, ids, tau = lm_admit_case(m, n, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "nan":
        scores[rng.random((m, n)) < 0.05] = np.nan
        scores[-1, n // 2], ids[-1, n // 2] = np.nan, n // 2
        tau[rng.random(m) < 0.3] = np.nan
    elif kind == "zeros":
        scores[::2] = -np.abs(scores[::2])
        zeros = np.array([-0.0, 0.0], np.float32)
        hit = rng.random((m, n)) < 0.4
        scores[hit] = zeros[rng.integers(0, 2, int(hit.sum()))]
        tau = zeros[rng.integers(0, 2, m)]
    elif kind == "padtile":
        bn = t_lm_ops.tile_width(n)
        ids[:, bn:2 * bn] = -1
    return scores, ids, tau


# (M, N, kind, views 4 bytes off 16-byte alignment, kernel launch_plan
# picks): grids of 1 and of 131, 133 and 1,025 streams at the deployment
# width N = 8,192, one whole tile (512), a last tile of one column (513),
# short rows in a 128-column tile (36, 33), rows of at most 32 (a thread
# a row), widths off a multiple of 4 and misaligned views (4-byte
# loads), NaN, signed zeros and all-pad tiles
LM_SEAM_CASES = [
    (1, 8192, "plain", False, "admit_vec"),
    (131, 8192, "nan", False, "admit_vec"),
    (133, 8192, "zeros", False, "admit_vec"),
    (1025, 8192, "padtile", False, "admit_vec"),
    (7, 512, "zeros", False, "admit_vec"), (9, 36, "nan", False, "admit_vec"),
    (5, 600, "padtile", False, "admit_vec"),
    (4, 1500, "nan", False, "admit_vec"),
    (7, 513, "nan", False, "admit_tile"),
    (9, 33, "zeros", False, "admit_tile"),
    (3, 8190, "padtile", False, "admit_tile"),
    (9, 36, "zeros", True, "admit_tile"),
    (5, 8192, "nan", True, "admit_tile"),
    (33, 16, "nan", False, "admit_narrow"),
    (9, 32, "zeros", False, "admit_narrow"),
    (9, 7, "nan", True, "admit_narrow")]


def lm_chunks(m, widths, seed):
    """Logmem chunks of the given widths: ids continue per row across
    chunks, 10% pads, tied scores; row 1 is all pad in the fourth chunk."""
    rng = np.random.default_rng(seed)
    out, lo = [], 0
    for c, w in enumerate(widths):
        s = tied_scores(rng, (m, w))
        i = np.tile(np.arange(lo, lo + w, dtype=np.int32), (m, 1))
        pad = rng.random((m, w)) < 0.1
        if c == 3:
            pad[1] = True
        s[pad], i[pad] = -np.inf, -1
        out.append((s, i))
        lo += w
    return out


def mixed_fleet_specs(spec_cls, docs=192, seed=5):
    """Six exact K=4 streams and five logmem K=64 tenants, and their
    traces."""
    rng = np.random.default_rng(seed)
    specs = [spec_cls(stream_id=i, k=4, r=float(docs / 2)) for i in range(6)]
    specs += [spec_cls(stream_id=100 + i, k=64, r=float(docs / 2),
                       engine="logmem") for i in range(5)]
    traces = rng.standard_normal((len(specs), docs)).astype(np.float32)
    return specs, traces


def ingest_mixed(eng, specs, traces, rng, batch=8, only_sids=None):
    """Route the traces as shuffled mixed batches of ``batch`` docs per
    stream."""
    sids = np.array([s.stream_id for s in specs])
    keep = (np.isin(sids, list(only_sids)) if only_sids is not None
            else np.ones(sids.size, bool))
    for t in range(0, traces.shape[1], batch):
        ms = np.repeat(sids[keep], batch)
        md = np.tile(np.arange(t, t + batch), int(keep.sum()))
        sc = traces[keep, t:t + batch].reshape(-1)
        perm = rng.permutation(ms.size)
        eng.ingest(ms[perm], sc[perm], md[perm])


def tf_case(n, seed, dtype=np.float32):
    """One stream's scores with ties and a few NaNs."""
    rng = np.random.default_rng(seed)
    s = tied_scores(rng, n)
    s[rng.random(n) < 0.01] = np.nan
    return s.astype(dtype)


# N: under one tile, one tile, several tiles of 4096 with a partial last
# one (5000, 100000), N % 4 != 0 (no 16-byte loads), a million
TF_CASES = [100, 128, 4096, 5000, 100_000, 4097, 1 << 20]


def same_bits(outs, refs):
    """Outputs equal to the plain version's bit for bit (a -0.0 differs
    from a +0.0), NaN where the plain version has NaN (any NaN)."""
    for a, r in zip(outs, refs):
        assert a.shape == r.shape and a.dtype == r.dtype
        if a.is_floating_point():
            nan = r.isnan()
            assert torch.equal(a.isnan(), nan)
            bits = {2: torch.int16, 4: torch.int32,
                    8: torch.int64}[a.element_size()]
            a, r = a[~nan].view(bits), r[~nan].view(bits)
        assert torch.equal(a, r)


# one tile of 128 scores whose maximum is zero, against a bar of 5.0:
# [-0.0, +0.0, -1.0 x 126] and its reverse (+0.0, as jnp.max gives
# wherever a +0.0 is in the tile) and -0.0 alone (-0.0)
ZERO_ROWS = ("mixed", "reversed", "negative")


def zero_row(kind):
    row = np.full(128, -1.0, np.float32)
    row[:2] = (-0.0, 0.0)
    if kind == "reversed":
        row = row[::-1].copy()
    elif kind == "negative":
        row[:] = -0.0
    return row


def zero_tied_scores(rng, m, n, bn):
    """``tied_scores`` (m, n) whose (row, tile of ``bn`` columns) pairs
    cycle through three kinds: as drawn; made non-positive (every zero
    then -0.0, so a tile max of -0.0 where it holds a zero); made
    non-positive with +0.0 put back at 3% of the entries (+0.0 beside
    -0.0)."""
    s = tied_scores(rng, (m, n))
    for r in range(m):
        for t, c in enumerate(range(0, n, bn)):
            kind = (r * -(-n // bn) + t) % 3
            if kind:
                s[r, c:c + bn] = -np.abs(s[r, c:c + bn])
            if kind == 2:
                put = rng.random(s[r, c:c + bn].shape) < 0.03
                s[r, c:c + bn][put] = 0.0
    return s


# (M, N, view 4 bytes off 16-byte alignment, kernel launch_plan picks) of
# batched_topk over zero_tied_scores against bars of ±0 and the pool's
# values: the vector kernel at N = 16 and 64, a thread a row at N = 7
# and off alignment, a warp a tile at N = 600 and off alignment
BTK_ZERO_CASES = [(9, 16, False, "scan_vec"), (5, 64, False, "scan_vec"),
                  (9, 7, False, "scan_narrow"), (7, 600, False, "scan_wide"),
                  (3, 128, False, "scan_vec"), (33, 16, True, "scan_narrow"),
                  (5, 64, True, "scan_wide")]


def btk_zero_case(m, n, seed):
    rng = np.random.default_rng(seed)
    scores = zero_tied_scores(rng, m, n, t_btk.tile_width(n))
    bars = TIED_POOL[rng.integers(0, TIED_POOL.size, m)]
    bars[::3] = -0.0
    return scores, bars


# (N, view 4 bytes off 16-byte alignment, kernel launch_plan picks) of
# topk_filter: a batch of the single-stream path, a partial last tile
# (5000), one tile under 128 columns (100), N % 4 != 0 (4097, 102), bases
# off 16-byte alignment
TF_PLAN_CASES = [(1 << 20, False, "filter_vec"), (5000, False, "filter_vec"),
                 (8192, False, "filter_vec"), (100, False, "filter_vec"),
                 (4097, False, "filter_tile"), (102, False, "filter_tile"),
                 (5000, True, "filter_tile"), (1 << 20, True, "filter_tile")]


def tf_zero_case(n, seed):
    """``zero_tied_scores`` as one stream of N scores, with a few NaNs."""
    rng = np.random.default_rng(seed)
    s = zero_tied_scores(rng, 1, n, t_tf.tile_width(n))[0]
    s[rng.random(n) < 0.01] = np.nan
    return s


# (M, N) of logmem_admit at lm_seam_case(m, n, "zeros", m + n): a last
# tile of one column, two tiles, a thread a row, the deployment width
LM_ZERO_CASES = [(6, 513), (5, 1500), (7, 20), (4, 8192)]


def ps_case(m, s, j, c, kind, seed, dtype=np.float64):
    """Inputs of ``plan_solve.enum_solve`` for M streams, S subsets, J
    steps, C sorted candidates (numpy). ``kind``: "plain" (unmasked),
    "masked" (step masks), "lb" (masks and pairwise lower bounds),
    "budget" (masks and a latency budget), "all" (all three, stream 0
    masked out entirely), "ties" (integer terms and constants equal
    across subsets: exact cost ties across tuples and subsets), "nan" (a
    NaN term in some subsets), "late_nan" (the cheapest subset, the last,
    holds a NaN in its last tuple alone in half the streams), "nan_then_inf"
    (the cheapest subset, the first, holds a NaN and every later subset is
    infeasible in half the streams: those return (+inf, 0))."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        fs = rng.integers(0, 3, (m, s, j, c)).astype(dtype)
        consts = [np.repeat(rng.integers(0, 3, (m, 1)), s, 1).astype(dtype)
                  for _ in range(3)]
    else:
        fs = rng.standard_normal((m, s, j, c)).astype(dtype)
        consts = [rng.standard_normal((m, s)).astype(dtype)
                  for _ in range(3)]
        consts[0][rng.random((m, s)) < 0.1] = np.inf  # infeasible subsets
    if kind == "nan":
        fs[rng.random((m, s)) < 0.2, 0, 0] = np.nan
    if kind == "late_nan":  # c0 = C-1 only in the last monotone tuple
        fs[:, -1] -= 10
        fs[rng.random(m) < 0.5, -1, 0, -1] = np.nan
    if kind == "nan_then_inf":
        half = rng.random(m) < 0.5
        fs[:, 0] -= 10
        fs[half, 0, 0, 0] = np.nan
        consts[0][half, 1:] = np.inf
    case = {"fs": fs, "consts": consts,
            "cand": np.sort(rng.uniform(0, 100, (m, s, c)), 2).astype(dtype)}
    if kind in ("masked", "lb", "budget", "all"):
        case["masks"] = [rng.random((m, s, c)) < 0.8 for _ in range(j)]
        case["masks"][0][:, :, 0] = True
        if kind == "all":
            for mk in case["masks"]:
                mk[0] = False
    if kind in ("lb", "all") and j > 1:
        kf = rng.uniform(20, 80, m).astype(dtype)
        caps = []
        for _ in range(j - 1):
            cap = (kf[:, None] * rng.uniform(0.1, 1.5, (m, s))).astype(dtype)
            cap[rng.random((m, s)) < 0.2] = np.inf
            caps.append(cap)
        case.update(kf=kf, pair_caps=caps)
    if kind in ("budget", "all"):
        case["alpha"] = (rng.uniform(-1, 1, (m, s, j)) / 100).astype(dtype)
        rhs = rng.uniform(-0.3, 1.0, (m, s)).astype(dtype)
        case["rhs"] = rhs
        case["atol"] = (1e-9 * np.abs(rhs) + 1e-15).astype(dtype)
    return case


def ps_tensors(case, device):
    """``ps_case`` as torch keyword arguments on ``device``."""
    def conv(x):
        if isinstance(x, list):
            return [conv(a) for a in x]
        return torch.tensor(x, device=device)
    out = {key: conv(v) for key, v in case.items()}
    return out.pop("fs"), out.pop("consts"), out


# (M, S, J, C, kind): the planner's group shapes (unconstrained 3-tier
# fleets: S <= 3, J <= 2, C <= 6; constrained: C <= 8), 4-tier
# constrained shapes (J = 3, C = 21 and 31; S = 4, J = 2, C = 19) and
# every kind of case. Both kernel mappings (plan_solve.launch_plan: tiles
# of streams for G < 64 and J <= 3, a block a stream otherwise) see ties,
# a NaN in the last tuple of the last subset and a NaN-skipped first
# subset before infeasible ones; tiles see J = 1, 2, 3 masked and not;
# M = 1000 leaves a partial tile, M = 1 a lone stream; J = 4 takes a
# block a stream at G = 35.
PS_CASES = [(300, 3, 1, 4, "plain"), (300, 1, 2, 6, "plain"),
            (300, 2, 1, 4, "masked"), (300, 1, 2, 8, "lb"),
            (300, 3, 2, 6, "budget"), (300, 3, 2, 8, "all"),
            (300, 3, 2, 6, "ties"), (300, 3, 2, 6, "nan"),
            (40, 1, 3, 21, "all"), (40, 4, 2, 21, "all"),
            (40, 2, 3, 9, "ties"), (64, 1, 3, 31, "all"),
            (64, 4, 2, 19, "all"), (64, 2, 3, 31, "ties"),
            (300, 3, 2, 8, "late_nan"), (64, 2, 3, 12, "late_nan"),
            (300, 3, 2, 6, "nan_then_inf"), (64, 3, 3, 12, "nan_then_inf"),
            (1000, 3, 2, 8, "all"), (1, 3, 2, 6, "budget"),
            (1, 1, 3, 31, "lb"), (300, 2, 3, 5, "all"),
            (300, 3, 3, 6, "nan_then_inf"), (40, 2, 4, 4, "all")]


def self_check_fleet(m, docs, rng):
    specs = []
    for i in range(m):
        k = (4, 8, 16, 32)[i % 4]
        cm = t_costs.hbm_host_preset(
            n_docs=docs, k=k, doc_gb=float(rng.uniform(1e-6, 1e-4)),
            window_seconds=float(rng.uniform(10, 600)), hbm_bw_gbps=819.0,
            host_link_gbps=float(rng.uniform(8, 64)),
            hbm_capacity_premium=float(rng.uniform(5, 500)))
        specs.append(t_eng.StreamSpec(stream_id=i, k=k, cost_model=cm))
    return specs


def run_self_check(device, m=48, docs=128, batch=32):
    """The metered multi-tenant self-check: survivors must bit-match
    independent simulator replays, and finalize_tiers must equal the
    meter's final-read attribution."""
    rng = np.random.default_rng(0)
    specs = self_check_fleet(m, docs, rng)
    eng = t_eng.StreamEngine(specs, device=device)
    traces = rng.standard_normal((m, docs)).astype(np.float32)
    for t in range(0, docs, batch):
        sids = np.repeat(np.arange(m), batch)
        dids = np.tile(np.arange(t, t + batch), m)
        perm = rng.permutation(sids.size)
        eng.ingest(sids[perm], traces[:, t:t + batch].reshape(-1)[perm],
                   dids[perm])
    survivors = eng.finalize()
    for i, spec in enumerate(specs):
        pol = t_place.Policy(r=eng.meter.rs[eng.stream_row(i)],
                             migrate_at_r=eng.plan.migrate(i))
        sim = t_sim.simulate(traces[i].astype(np.float64), spec.k, pol)
        np.testing.assert_array_equal(survivors[i], sim.survivor_ids)
    for sid, out in eng.finalize_tiers().items():
        row = eng.stream_row(sid)
        valid = out["ids"] >= 0
        host = eng.meter._effective_tier(np.array([row]), out["ids"][None])[0]
        np.testing.assert_array_equal(out["tiers"][valid], host[valid])
        np.testing.assert_array_equal(out["counts"], eng.meter.reads[row])
    return eng


def dense_chunks(m, w, n_chunks, seed):
    rng = np.random.default_rng(seed)
    for c in range(n_chunks):
        s = rng.standard_normal((m, w)).astype(np.float32)
        if c == 1:
            s[0, 3] = np.nan
        yield [(s, np.tile(np.arange(c * w, (c + 1) * w, dtype=np.int32),
                           (m, 1)))]


def uniform_engine(module, device=None):
    specs = [module.StreamSpec(stream_id=i, k=8,
                               boundaries=(30.0, 70.0), migrate=i % 2 == 1)
             for i in range(16)]
    return (module.StreamEngine(specs) if device is None
            else module.StreamEngine(specs, device=device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", BTK_CASES)
def test_batched_topk_kernel_equals_plain(m, n, cuda_device):
    scores, bars = btk_case(m, n, n)
    s, b = (torch.tensor(x, device=cuda_device) for x in (scores, bars))
    before = t_btk.launches
    out = t_btk.batched_topk_filter(s, b)
    torch.cuda.synchronize()
    assert t_btk.launches == before + 1
    for a, r in zip(out, t_btk.reference(s, b)):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,b", TA_CASES)
def test_tier_assign_kernel_equals_plain(m, k, b, cuda_device):
    ids, bounds, floor = ta_case(m, k, b, k)
    args = [torch.tensor(x, device=cuda_device) for x in
            (ids, t_ta.quantize_boundaries(bounds), floor)]
    before = t_ta.launches
    out = t_ta.tier_assign(*args)
    torch.cuda.synchronize()
    assert t_ta.launches == before + 1
    for a, r in zip(out, t_ta.reference(*args, b + 1)):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,kind,offset,want", BTK_SEAM_CASES)
def test_batched_topk_kernel_seams(m, n, kind, offset, want, cuda_device):
    scores, bars = btk_seam_case(m, n, kind, m + n)
    s, b = (torch.tensor(x, device=cuda_device) for x in (scores, bars))
    if offset:
        s = offset_view(s)
    assert t_btk.launch_plan(s, b)[0] == want
    before = t_btk.launches
    out = t_btk.batched_topk_filter(s, b)
    torch.cuda.synchronize()
    assert t_btk.launches == before + 1
    same_exactly(out, t_btk.reference(s, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,b,t,offset,want", TA_SEAM_CASES)
def test_tier_assign_kernel_seams(m, k, b, t, offset, want, cuda_device):
    ids, bounds, floor = ta_edge_case(m, k, b, t, m + k + b + t)
    args = [torch.tensor(x, device=cuda_device) for x in
            (ids, t_ta.quantize_boundaries(bounds), floor)]
    if offset:
        args[0] = offset_view(args[0])
    assert t_ta.launch_plan(*args)[0] == want
    before = t_ta.launches
    out = t_ta.tier_assign(*args, n_tiers=t)
    torch.cuda.synchronize()
    assert t_ta.launches == before + 1
    same_exactly(out, t_ta.reference(*args, t))


@pytest.mark.cuda
def test_engine_on_card_equals_cpu(cuda_device):
    cpu = uniform_engine(t_eng, "cpu")
    gpu = uniform_engine(t_eng, cuda_device)
    b0, t0 = t_btk.launches, t_ta.launches
    cpu.ingest_chunks(dense_chunks(16, 16, 8, 3))
    assert gpu.ingest_chunks(dense_chunks(16, 16, 8, 3)) == 8
    assert t_btk.launches == b0 + 8
    for a, b in zip(cpu.states()[0], gpu.states()[0]):
        assert torch.equal(a, b.cpu())
    for f in METER_FIELDS:
        np.testing.assert_array_equal(getattr(cpu.meter, f),
                                      getattr(gpu.meter, f), err_msg=f)
    ct, gt = cpu.finalize_tiers(), gpu.finalize_tiers()
    assert t_ta.launches == t0 + 1
    for sid in ct:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(ct[sid][key], gt[sid][key])


@pytest.mark.cuda
def test_self_check_on_card(cuda_device):
    run_self_check(cuda_device)


@pytest.mark.cuda
def test_double_buffered_ingest_equals_sequential_on_card(cuda_device):
    """ingest_chunks (pinned buffers, side-stream copies) against one
    ingest_dense per chunk, both on the card, at a width where the next
    chunk's copy overlaps the running step."""
    m, w, n_chunks = 200_000, 16, 12
    specs = [t_eng.StreamSpec(stream_id=i, k=8, boundaries=(64.0, 128.0))
             for i in range(m)]
    piped = t_eng.StreamEngine(specs, device=cuda_device)
    plain = t_eng.StreamEngine(specs, device=cuda_device)
    assert piped.ingest_chunks(dense_chunks(m, w, n_chunks, 5),
                               meter=False) == n_chunks
    for dense in dense_chunks(m, w, n_chunks, 5):
        plain.ingest_dense(dense, meter=False)
    for a, b in zip(piped.states()[0], plain.states()[0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", LM_CASES)
def test_logmem_admit_kernel_equals_plain(m, n, cuda_device):
    scores, ids, tau = lm_admit_case(m, n, n)
    for taus in (tau, np.full_like(tau, -np.inf)):
        args = [torch.tensor(x, device=cuda_device)
                for x in (scores, ids, taus)]
        before = t_lm_ops.launches
        out = t_lm_ops.logmem_admit(*args)
        torch.cuda.synchronize()
        assert t_lm_ops.launches == before + 1
        for a, r in zip(out, t_lm_ops.reference(*args)):
            assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,kind,offset,want", LM_SEAM_CASES)
def test_logmem_admit_kernel_seams(m, n, kind, offset, want, cuda_device):
    args = [torch.tensor(x, device=cuda_device)
            for x in lm_seam_case(m, n, kind, m + n)]
    if offset:
        args[0], args[1] = offset_view(args[0]), offset_view(args[1])
    assert t_lm_ops.launch_plan(*args)[0] == want
    before = t_lm_ops.launches
    out = t_lm_ops.logmem_admit(*args)
    torch.cuda.synchronize()
    assert t_lm_ops.launches == before + 1
    same_exactly(out, t_lm_ops.reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", TF_CASES)
def test_topk_filter_kernel_equals_plain(n, cuda_device):
    for dtype in (torch.float32, torch.bfloat16):
        s = torch.tensor(tf_case(n, n), device=cuda_device).to(dtype)
        for thr in (0.5, float("-inf"), 100.0):
            t = torch.tensor(thr, device=cuda_device)
            before = t_tf.launches
            out = t_tf.topk_filter(s, t)
            torch.cuda.synchronize()
            assert t_tf.launches == before + 1
            for a, r in zip(out, t_tf.reference(s, t)):
                assert torch.equal(a, r)


@pytest.mark.cuda
def test_filter_then_merge_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(7)
    cpu = t_topk.init(32, device="cpu")
    gpu = t_topk.init(32, device=cuda_device)
    for step in range(5):
        s = tied_scores(rng, 5000)
        i = np.arange(step * 5000, (step + 1) * 5000, dtype=np.int32)
        cpu, cw = t_tf.filter_then_merge(cpu, torch.tensor(s),
                                         torch.tensor(i))
        gpu, gw = t_tf.filter_then_merge(
            gpu, torch.tensor(s, device=cuda_device),
            torch.tensor(i, device=cuda_device))
        assert torch.equal(cw, gw.cpu())
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())


def zero_row_run(kernel, kind, device):
    """(kernel outputs, plain outputs) of one scan kernel on ``zero_row``
    against 5.0 on ``device``; the kernel's launch counter must rise by
    one."""
    row = torch.tensor(zero_row(kind), device=device)
    five = torch.tensor([5.0], device=device)
    if kernel == "batched_topk":
        mod, args = t_btk, (row[None], five)
        call = t_btk.batched_topk_filter
    elif kernel == "topk_filter":
        mod, args, call = t_tf, (row, five[0]), t_tf.topk_filter
    else:
        ids = torch.arange(128, dtype=torch.int32, device=device)[None]
        mod, args = t_lm_ops, (row[None], ids, five)
        call = t_lm_ops.logmem_admit
    before = mod.launches
    out = call(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    return out, mod.reference(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ZERO_ROWS)
@pytest.mark.parametrize("kernel",
                         ["batched_topk", "topk_filter", "logmem_update"])
def test_scan_kernels_zero_row_by_bits(kernel, kind, cuda_device):
    out, ref = zero_row_run(kernel, kind, cuda_device)
    same_bits(out, ref)
    assert bool(torch.signbit(out[-1]).all()) == (kind == "negative")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,kind,offset,want", BTK_SEAM_CASES)
def test_batched_topk_kernel_seams_by_bits(m, n, kind, offset, want,
                                           cuda_device):
    scores, bars = btk_seam_case(m, n, kind, m + n)
    s, b = (torch.tensor(x, device=cuda_device) for x in (scores, bars))
    if offset:
        s = offset_view(s)
    assert t_btk.launch_plan(s, b)[0] == want
    same_bits(t_btk.batched_topk_filter(s, b), t_btk.reference(s, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,offset,want", BTK_ZERO_CASES)
def test_batched_topk_kernel_tied_zeros_by_bits(m, n, offset, want,
                                                cuda_device):
    scores, bars = btk_zero_case(m, n, m + n)
    s, b = (torch.tensor(x, device=cuda_device) for x in (scores, bars))
    if offset:
        s = offset_view(s)
    assert t_btk.launch_plan(s, b)[0] == want
    same_bits(t_btk.batched_topk_filter(s, b), t_btk.reference(s, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,kind,offset,want", LM_SEAM_CASES + [
    (m, n, "zeros", False, None) for m, n in LM_ZERO_CASES])
def test_logmem_admit_kernel_seams_by_bits(m, n, kind, offset, want,
                                           cuda_device):
    args = [torch.tensor(x, device=cuda_device)
            for x in lm_seam_case(m, n, kind, m + n)]
    if offset:
        args[0], args[1] = offset_view(args[0]), offset_view(args[1])
    assert want in (None, t_lm_ops.launch_plan(*args)[0])
    same_bits(t_lm_ops.logmem_admit(*args), t_lm_ops.reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, -0.0, float("-inf")])
@pytest.mark.parametrize("n,offset,want", TF_PLAN_CASES)
def test_topk_filter_kernel_plans_by_bits(n, offset, want, thr,
                                          cuda_device):
    s = torch.tensor(tf_zero_case(n, n), device=cuda_device)
    if offset:
        s = offset_view(s)
    t = torch.tensor(thr, device=cuda_device)
    assert t_tf.launch_plan(s)[0] == want
    before = t_tf.launches
    out = t_tf.topk_filter(s, t)
    torch.cuda.synchronize()
    assert t_tf.launches == before + 1
    same_bits(out, t_tf.reference(s, t))


@pytest.mark.cuda
def test_topk_filter_launcher_refuses_picks_the_inputs_do_not_allow(
        cuda_device):
    """filter_vec on a base off 16-byte alignment or on N % 4 != 0, or an
    unknown kernel id: the launcher returns an error and launches
    nothing."""
    t = torch.tensor(0.5, device=cuda_device)
    for s, kernel in ((offset_view(torch.zeros(8192, device=cuda_device)),
                       t_tf.KERNELS["filter_vec"]),
                      (torch.zeros(4097, device=cuda_device),
                       t_tf.KERNELS["filter_vec"]),
                      (torch.zeros(8192, device=cuda_device), 7)):
        n = s.numel()
        bn = t_tf.tile_width(n)
        tiles = -(-n // bn)
        mask = torch.empty(n, dtype=torch.int8, device=cuda_device)
        counts = torch.full((tiles,), -1, dtype=torch.int32,
                            device=cuda_device)
        tmax = torch.empty(tiles, device=cuda_device)
        err = t_tf._kernel()(s.data_ptr(), t.data_ptr(), mask.data_ptr(),
                             counts.data_ptr(), tmax.data_ptr(), n, bn,
                             tiles, kernel,
                             torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err != 0
        assert (counts == -1).all()


def mixed_dense_chunks(n_chunks, seed):
    """Two buckets of different widths: 16 exact K=8 streams x 16 and 4
    logmem K=256 tenants x 512, NaN and Inf in the second chunk."""
    rng = np.random.default_rng(seed)
    for c in range(n_chunks):
        s0 = rng.standard_normal((16, 16)).astype(np.float32)
        s1 = tied_scores(rng, (4, 512))
        if c == 1:
            s0[0, 3], s1[1, 7] = np.nan, np.inf
        yield [(s0, np.tile(np.arange(16 * c, 16 * c + 16, dtype=np.int32),
                            (16, 1))),
               (s1, np.tile(np.arange(512 * c, 512 * c + 512,
                                      dtype=np.int32), (4, 1)))]


def mixed_engine(device, obs=None, mesh=None):
    specs = [t_eng.StreamSpec(stream_id=i, k=8, boundaries=(30.0, 70.0),
                              migrate=i % 2 == 1) for i in range(16)]
    specs += [t_eng.StreamSpec(stream_id=100 + i, k=256, r=1024.0,
                               engine="logmem") for i in range(4)]
    return t_eng.StreamEngine(specs, device=device, obs=obs, mesh=mesh)


@pytest.mark.cuda
def test_mixed_engine_on_card_equals_cpu(cuda_device):
    """Exact and logmem buckets in one double-buffered ingest on the card
    against the same engine on the CPU: every state leaf, every meter
    counter, finalize_tiers; the logmem epilogue's sorts on CUDA keep the
    CPU's order."""
    cpu, gpu = mixed_engine("cpu"), mixed_engine(cuda_device)
    b0, l0 = t_btk.launches, t_lm_ops.launches
    cpu.ingest_chunks(mixed_dense_chunks(12, 4))
    assert gpu.ingest_chunks(mixed_dense_chunks(12, 4)) == 12
    assert (t_btk.launches - b0, t_lm_ops.launches - l0) == (12, 12)
    for cs, gs in zip(cpu.states(), gpu.states()):
        for a, b in zip(cs, gs):
            assert torch.equal(a, b.cpu())
    for f in METER_FIELDS + ("logmem",):
        np.testing.assert_array_equal(getattr(cpu.meter, f),
                                      getattr(gpu.meter, f), err_msg=f)
    ct, gt = cpu.finalize_tiers(), gpu.finalize_tiers()
    assert ct.keys() == gt.keys() == set(range(16))
    for sid in ct:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(ct[sid][key], gt[sid][key])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,s,j,c,kind", PS_CASES)
def test_plan_solve_kernel_equals_plain(m, s, j, c, kind, dtype,
                                        cuda_device):
    fs, consts, kw = ps_tensors(ps_case(m, s, j, c, kind, m + c, dtype),
                                cuda_device)
    args = t_ps.solve_inputs(fs, consts, **kw)
    n0 = t_ps.launches
    out = t_ps.plan_solve(*args)
    torch.cuda.synchronize()
    assert t_ps.launches == n0 + 1
    for a, r in zip(out, t_ps.reference(*args)):
        assert torch.equal(a, r)


def planner_fleet(rng, m, t, constrained):
    """A random t-tier fleet's cost arrays and, when ``constrained``,
    capacities, latencies and an SLO (the reference's planner tests'
    draws)."""
    n = rng.integers(2_000, 1_000_000, m).astype(np.float64)
    k = np.maximum(1, n * rng.uniform(0.001, 0.1, m))
    r = lambda s: 10.0 ** rng.uniform(-8, -3, s)  # noqa: E731
    args = (r((m, t)), r((m, t)), r((m, t)), n, k, np.ones(m))
    if not constrained:
        return args, {}
    cap = k[:, None] * rng.uniform(0.05, 2.0, (m, t))
    cap[rng.random((m, t)) < 0.3] = np.inf
    lat = np.sort(10.0 ** rng.uniform(-3, 2, (m, t)), axis=1)
    slo = np.where(rng.random(m) < 0.6, np.sqrt(lat[:, 0] * lat[:, -1]),
                   np.inf)
    return args, {"cap": cap, "lat": lat, "slo": slo}


@pytest.mark.cuda
@pytest.mark.parametrize("t,constrained", [(2, True), (3, False), (3, True),
                                           (4, False), (4, True)])
def test_device_planner_on_card_matches_oracle(t, constrained, cuda_device):
    """float64 plans on the card: feasibility and migrate equal to the
    NumPy oracle's, totals within 1e-11 relative, infeasible bounds
    zeroed."""
    args, cons = planner_fleet(np.random.default_rng(t), 2000, t,
                               constrained)
    ref = t_shp.plan_ntier_arrays(*args, **cons, backend="numpy")
    n0 = t_ps.launches
    got = t_dev.plan_ntier_arrays_device(*args, **cons, precision="float64",
                                         device=cuda_device)
    assert t_ps.launches - n0 == 2 * t - 2  # one per group of subsets
    feas = np.isfinite(ref["total"])
    np.testing.assert_array_equal(np.isfinite(got["total"]), feas)
    assert (got["bounds"][~feas] == 0).all()
    np.testing.assert_allclose(got["total"][feas], ref["total"][feas],
                               rtol=1e-11)
    np.testing.assert_array_equal(got["migrate"], ref["migrate"])


@pytest.mark.cuda
def test_engine_on_card_plans_on_card(cuda_device):
    rng = np.random.default_rng(0)
    args, _ = planner_fleet(rng, 64, 3, False)
    n0 = t_ps.launches
    out = t_shp.plan_ntier_arrays(*args)  # "auto": the card
    assert t_ps.launches - n0 == 4 and np.isfinite(out["total"]).all()
    specs = self_check_fleet(64, 128, rng)
    models = [s.cost_model.as_ntier() for s in specs]
    n0 = t_ps.launches
    eng = t_eng.StreamEngine(
        [t_eng.StreamSpec(stream_id=i, k=cm.workload.k, cost_model=cm)
         for i, cm in enumerate(models)], device=cuda_device)
    assert t_ps.launches - n0 == 2 and eng.plan.m == 64


@pytest.mark.cuda
def test_log2_floors_powers_of_two_on_card(cuda_device):
    """The phase rule ⌊log₂(t/K)⌋ needs log2 exact at powers of two."""
    x = torch.tensor([2.0 ** p for p in range(31)], device=cuda_device)
    assert torch.floor(torch.log2(x)).int().tolist() == list(range(31))


# (b, sq, skv, h, kvh, hd, causal, window): the reference's sweeps, ragged
# and cross lengths, windows, non-causal, grouped heads, the serve path's
# head layout
FA_CASES = [(1, 128, 128, 2, 2, 64, True, 0), (2, 256, 256, 1, 1, 32, True, 0),
            (1, 100, 100, 2, 2, 64, True, 0), (1, 64, 192, 2, 2, 32, True, 0),
            (1, 128, 128, 2, 2, 32, True, 16), (1, 128, 128, 2, 2, 32, True, 64),
            (1, 64, 64, 2, 2, 32, False, 0), (1, 70, 33, 4, 2, 16, False, 16),
            (1, 40, 24, 2, 2, 16, True, 0), (2, 300, 300, 32, 8, 64, True, 0),
            (1, 200, 520, 8, 2, 64, True, 100),
            # head dim 128: starcoder2-3b's heads (24 over 2), ragged GQA,
            # Sq < Skv with a window, non-causal, rows with no key
            (1, 256, 256, 24, 2, 128, True, 0), (2, 300, 300, 8, 2, 128, True, 0),
            (1, 100, 700, 8, 2, 128, True, 256), (1, 96, 96, 4, 4, 128, False, 0),
            (1, 40, 24, 2, 1, 128, True, 0),
            # the forward's blocks of 128 query rows (64 a consumer
            # warpgroup): a last block of one row, of two, a second
            # consumer partly filled, Sq past Skv over twelve blocks
            (1, 257, 64, 2, 2, 64, True, 0), (2, 130, 333, 2, 1, 16, True, 0),
            (1, 90, 33, 2, 2, 32, True, 0), (1, 1500, 448, 4, 2, 128, True, 0)]


def fa_case(b, sq, skv, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", FA_CASES)
def test_flash_attention_kernel_equals_plain(b, sq, skv, h, kvh, hd, causal,
                                             window, dtype, cuda_device):
    q, k, v = (torch.tensor(x, device=cuda_device).to(dtype)
               for x in fa_case(b, sq, skv, h, kvh, hd, sq + skv))
    before = t_fa.launches
    out = t_fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1
    ref = t_fa.reference(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == ref.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# (b, sq, skv, h, kvh, hd, causal, window): hymba-1.5b's odd group of 5
# query heads a KV head, ragged under a window of 100, and at its prefill
# (a batch of 1 of 2048 queries under its 1024-token window)
FA_ODD_GROUP_CASES = [(1, 300, 300, 25, 5, 64, True, 100),
                      (1, 2048, 2048, 25, 5, 64, True, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window",
                         FA_ODD_GROUP_CASES)
def test_flash_attention_odd_group_window_equals_plain(
        b, sq, skv, h, kvh, hd, causal, window, dtype, cuda_device):
    test_flash_attention_kernel_equals_plain(b, sq, skv, h, kvh, hd, causal,
                                             window, dtype, cuda_device)


# (b, sq, skv, h, kvh, hd, causal, window): the prefills of 8 x 1024 at
# head dim 128 that chip_smoke.py's phase 25 serves, yi-9b's 32 query
# heads over 4 (a group of 8) and command-r-plus-104b's 96 over 8
FA_DENSE_FULL_CASES = [(8, 1024, 1024, 32, 4, 128, True, 0),
                       (8, 1024, 1024, 96, 8, 128, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window",
                         FA_DENSE_FULL_CASES)
def test_flash_attention_dense_full_prefills_equal_plain(
        b, sq, skv, h, kvh, hd, causal, window, dtype, cuda_device):
    test_flash_attention_kernel_equals_plain(b, sq, skv, h, kvh, hd, causal,
                                             window, dtype, cuda_device)


@pytest.mark.cuda
def test_flash_attention_head_dim_outside_the_build_raises(cuda_device):
    q = torch.zeros((1, 4, 2, 48), device=cuda_device)
    with pytest.raises(NotImplementedError, match="head dims"):
        t_fa.flash_attention(q, q, q)


# (b, v): one span and many (ops.split_columns), starcoder2-3b's
# vocabulary, rows that fill the card (one span a row) and 132 rows (two),
# hymba-1.5b's (V % 4 != 0: scalar loads), mamba2-2.7b's, yi-9b's and
# command-r-plus-104b's decode steps
ENT_CASES = [(1, 128), (3, 300), (8, 2048), (5, 5000), (16, 32000),
             (8, 128256), (4, 128257), (8, 49152), (132, 128256),
             (300, 5001), (8, 32001), (8, 50280), (8, 64000), (8, 256000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", ENT_CASES)
def test_entropy_nll_kernel_equals_plain(b, v, dtype, cuda_device):
    rng = np.random.default_rng(b * 1000 + v)
    logits = torch.tensor(rng.standard_normal((b, v)) * 3,
                          device=cuda_device).to(dtype)
    labels = torch.tensor(rng.integers(0, v, b), dtype=torch.int32,
                          device=cuda_device)
    before = t_ent.launches
    ent, nll = t_ent.entropy_nll(logits, labels)
    torch.cuda.synchronize()
    assert t_ent.launches == before + 1
    r_ent, r_nll = t_ent.reference(logits, labels)
    torch.testing.assert_close(ent, r_ent, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(nll, r_nll, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_entropy_nll_extremes_and_unaligned_rows(cuda_device):
    v = 1024
    peaked = torch.zeros((1, v), device=cuda_device)
    peaked[0, 3] = 100.0
    ent, nll = t_ent.entropy_nll(peaked, torch.tensor([3], device=cuda_device))
    assert float(ent[0]) < 1e-3 and abs(float(nll[0])) < 1e-3
    ent, _ = t_ent.entropy_nll(torch.zeros((2, v), device=cuda_device),
                               torch.zeros(2, dtype=torch.int32,
                                           device=cuda_device))
    torch.testing.assert_close(ent.cpu(), torch.full((2,), float(np.log(v))))
    # a view that starts 4 bytes into its storage takes the scalar loads
    base = torch.randn(3 * v + 1, device=cuda_device)
    rows = base[1:].view(3, v)
    labels = torch.tensor([0, 5, v - 1], device=cuda_device)
    for a, r in zip(t_ent.entropy_nll(rows, labels),
                    t_ent.reference(rows, labels)):
        torch.testing.assert_close(a, r, rtol=2e-5, atol=2e-5)


def params_to(tree, device):
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("tenants", [1, 3])
def test_serve_on_card_equals_cpu(tenants, cuda_device):
    """The reduced llama3.2-1b serve loop on the card (flash_attention in
    prefill, entropy_scores per decode step) against the CPU's run with
    the same weights: tokens equal, scores within 2e-5, retention equal
    where no two scores lie within that tolerance (checked first)."""
    cfg = t_configs.get_config("llama3.2-1b", reduced=True)
    cpu = t_lm.init_params(cfg, seed=0, device="cpu")
    gpu = params_to(cpu, cuda_device)
    run = dict(requests=24, batch=8, prompt_len=8, gen_len=6, topk=8,
               tenants=tenants)
    t_fa.launches = t_ent.launches = 0
    res = t_serve.serve(cfg, gpu, device=cuda_device, **run)
    batches, layers = 3, cfg.n_layers
    assert (t_fa.launches, t_ent.launches) == (layers * batches,
                                                5 * batches)
    ref = t_serve.serve(cfg, cpu, device="cpu", **run)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=2e-5, atol=2e-5)
    assert np.diff(np.sort(ref.scores)).min() > 4e-5
    if tenants == 1:
        assert res.retained == ref.retained
        assert res.store.ledger.as_dict() == ref.store.ledger.as_dict()
    else:
        for t in ref.retained:
            np.testing.assert_array_equal(res.retained[t], ref.retained[t])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_serve_ssm_families_on_card_equal_cpu(arch, cuda_device):
    """Reduced mamba2-2.7b and hymba-1.5b served on the card (the SSD scan
    and recurrence as plain tensor operations, flash_attention in hymba's
    prefill, entropy_scores per decode step) against the CPU's run with
    the same weights: exact launch counts (no flash launch for mamba2),
    tokens equal, scores within 2e-5, retention equal."""
    cfg = t_configs.get_config(arch, reduced=True)
    cpu = t_lm.init_params(cfg, seed=0, device="cpu")
    run = dict(requests=24, batch=8, prompt_len=8, gen_len=6, topk=8)
    t_fa.launches = t_ent.launches = 0
    res = t_serve.serve(cfg, params_to(cpu, cuda_device), device=cuda_device,
                        **run)
    attn_layers = sum(s.count for s in cfg.layers
                      if s.mixer in ("attn", "attn_ssm_parallel"))
    assert (t_fa.launches, t_ent.launches) == (attn_layers * 3, 5 * 3)
    ref = t_serve.serve(cfg, cpu, device="cpu", **run)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=2e-5, atol=2e-5)
    assert np.diff(np.sort(ref.scores)).min() > 4e-5
    assert res.retained == ref.retained
    assert res.store.ledger.as_dict() == ref.store.ledger.as_dict()


@pytest.mark.cuda
def test_entropy_nll_kernel_is_deterministic(cuda_device):
    """The span merge runs in a fixed order: two calls agree bit for bit."""
    logits = torch.randn((8, 128256), device=cuda_device) * 3
    labels = torch.arange(8, device=cuda_device)
    a, b = t_ent.entropy_nll(logits, labels), t_ent.entropy_nll(logits, labels)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_flash_attention_copies_an_unaligned_view(cuda_device):
    """A q that starts 4 bytes into its storage is copied to an aligned
    tensor before the kernel's 16-byte copies."""
    base = torch.randn(1 * 64 * 2 * 64 + 1, device=cuda_device)
    q = base[1:].view(1, 64, 2, 64)
    k = torch.randn((1, 64, 2, 64), device=cuda_device)
    torch.testing.assert_close(t_fa.flash_attention(q, k, k),
                               t_fa.reference(q, k, k), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# online re-planning: the four-tier re-solve through plan_solve
# ---------------------------------------------------------------------------

def four_tier_models(rng, r, n=None, k=None):
    """r random four-tier tenants (write-cheap hot tiers, costs jittered)
    capped on the first, second and last tiers: the re-solve's four-tier
    subset then takes plan_solve's masked route (a pair cap on a middle
    tier) and its terms carry +inf (the last tier's folded mask)."""
    models, csets = [], []
    for _ in range(r):
        tiers = []
        put, get, rent = 1e-6, 3e-4, 0.05
        for _ in range(4):
            tiers.append(t_topo.TierSpec(t_costs.TierCosts(
                "t", put_per_doc=put * rng.uniform(0.8, 1.2),
                get_per_doc=get * rng.uniform(0.8, 1.2),
                storage_per_gb_month=rent),
                read_latency_s=float(10.0 ** rng.uniform(-3, 1))))
            put *= 40.0
            get /= 40.0
            rent /= 3.0
        nd = n if n is not None else int(rng.integers(5_000, 50_000))
        kk = k if k is not None else int(rng.integers(8, 128))
        wl = t_costs.WorkloadSpec(n_docs=nd, k=kk, doc_gb=1e-4,
                                  window_months=0.5)
        models.append(t_topo.TierTopology(tiers=tuple(tiers)).cost_model(wl))
        csets.append(t_cons.ConstraintSet(
            t_cons.TierCapacity(0, kk * rng.uniform(1.0, 2.0)),
            t_cons.TierCapacity(1, kk * rng.uniform(0.3, 0.9)),
            t_cons.TierCapacity(3, kk * rng.uniform(0.3, 0.9))))
    return models, csets


def resolve_group(seed, r=64):
    """A drift-flagged group's stacked arrays, as
    ``Replanner._solve_group`` hands them to ``replan_device``."""
    rng = np.random.default_rng(seed)
    models, csets = four_tier_models(rng, r)
    st = t_replan.Replanner(models, constraints=csets)._stacks[4]
    n = st["n"]
    n0 = np.floor(rng.uniform(0.1, 0.9, r) * n)
    b0 = np.sort(rng.uniform(0, 1, (r, 3)) * n[:, None], axis=1)
    return ([st[key] for key in ("cw", "cr", "cs", "n", "k", "rpw", "cap",
                                 "lat", "slo")]
            + [n0, rng.uniform(0.3, 8.0, r), b0])


def captured_resolve_solve(args, monkeypatch):
    """The ``ops.enum_solve`` call of a CPU re-solve: (fs, consts, kw)."""
    seen = []
    real = t_ps.enum_solve

    def spy(fs, consts, **kw):
        seen.append((fs, consts, kw))
        return real(fs, consts, **kw)

    monkeypatch.setattr(t_ps, "enum_solve", spy)
    t_rd.solve_group(*args, device="cpu")
    monkeypatch.setattr(t_ps, "enum_solve", real)
    assert len(seen) == 1
    return seen[0]


def with_blocked_first_subset(fs, consts, kw):
    """S = 2: an all-+inf copy of the subset ahead of the subset itself."""
    fs2 = torch.cat([torch.full_like(fs, torch.inf), fs], dim=1)
    consts2 = tuple(torch.cat([c, c], dim=1) for c in consts)
    kw2 = {}
    for key, v in kw.items():
        if key == "kf":
            kw2[key] = v
        elif key == "pair_caps":
            kw2[key] = [None if c is None else torch.cat([c, c], dim=1)
                        for c in v]
        else:
            kw2[key] = torch.cat([v, v], dim=1)
    return fs2, consts2, kw2


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["as-is", "blocked-stream",
                                     "blocked-subset"])
def test_resolve_plan_solve_with_inf_terms_equals_plain(variant, cuda_device,
                                                        monkeypatch):
    fs, consts, kw = captured_resolve_solve(resolve_group(5), monkeypatch)
    assert torch.isinf(fs).any() and kw.get("pair_caps") is not None
    if variant == "blocked-stream":  # every tuple of stream 0 infeasible
        fs = fs.clone()
        fs[0] = torch.inf
    if variant == "blocked-subset":
        fs, consts, kw = with_blocked_first_subset(fs, consts, kw)
    inputs = t_ps.solve_inputs(fs, consts, **kw)
    ref = t_ps.reference(*inputs)
    dev = [x.to(cuda_device) if x is not None else None for x in inputs[:3]]
    grids = tuple(x.to(cuda_device) for x in inputs[3])
    before = t_ps.launches
    out = t_ps.plan_solve(*dev, grids)
    torch.cuda.synchronize()
    assert t_ps.launches == before + 1
    out = [x.cpu() for x in out]
    same_exactly(out, ref)
    if variant == "blocked-stream":
        assert torch.isinf(out[0][0]) and int(out[1][0]) == 0
    if variant == "blocked-subset":
        g = inputs[2].shape[0]
        fin = torch.isfinite(ref[0])
        assert bool((ref[1][fin] >= g).all())


@pytest.mark.cuda
def test_resolve_on_card_equals_cpu(cuda_device):
    args = resolve_group(9, r=256)
    before = t_ps.launches
    total, bounds, old = t_rd.solve_group(*args, device=cuda_device)
    assert t_ps.launches == before + 1
    ref_total, ref_bounds, ref_old = t_rd.solve_group(*args, device="cpu")
    fin = np.isfinite(ref_total)
    np.testing.assert_array_equal(np.isfinite(total), fin)
    np.testing.assert_array_equal(bounds[fin], ref_bounds[fin])
    np.testing.assert_allclose(total[fin], ref_total[fin], rtol=1e-11,
                               atol=0)
    np.testing.assert_allclose(old, ref_old, rtol=1e-11, atol=0)


@pytest.mark.cuda
def test_replanning_engine_on_card_equals_cpu(cuda_device):
    """A drifted constrained four-tier fleet with replan= on the card and on
    the CPU (the CPU pinned to the same re-solve, backend="device"), both
    from the same planned boundaries: drift leaves, events, boundaries,
    survivors and tiers."""
    rng = np.random.default_rng(4)
    m, n, k = 24, 3072, 16
    models, csets = four_tier_models(rng, m, n=n, k=k)
    cfg = t_replan.ReplanConfig(drift=t_drift.DriftConfig(alpha=0.05))
    specs = [t_eng.StreamSpec(stream_id=i, k=k, cost_model=cm)
             for i, cm in enumerate(models)]
    gpu = t_eng.StreamEngine(specs, constraints=csets, replan=cfg,
                             device=cuda_device)
    # the CPU run starts from the card's planned boundaries
    fixed = [t_eng.StreamSpec(
        stream_id=i, k=k, cost_model=cm, migrate=bool(gpu.meter.migrate[i]),
        boundaries=tuple(gpu.meter.boundaries[i][:3])) for i, cm in
        enumerate(models)]
    cpu = t_eng.StreamEngine(fixed, constraints=csets, replan=cfg,
                             device="cpu")
    cpu._replanner.backend = "device"  # the card's re-solve, plain plan_solve
    traces = np.stack([t_sim.drifted_rank_trace(n, rng, [(800, 8.0)])
                       for _ in range(m)]).astype(np.float32)
    chunks = [[(traces[:, c0:c0 + 64],
                np.tile(np.arange(c0, c0 + 64, dtype=np.int32), (m, 1)))]
              for c0 in range(0, n, 64)]
    p0 = t_ps.launches
    gpu.ingest_chunks(chunks)
    assert t_ps.launches > p0
    cpu.ingest_chunks(chunks)
    assert len(gpu.replan_events) == len(cpu.replan_events) > 0
    for a, b in zip(gpu.replan_events, cpu.replan_events):
        assert (a.stream_id, a.position, a.rho, a.old_bounds, a.new_bounds,
                a.applied, a.feasible, a.moved_docs) == (
            b.stream_id, b.position, b.rho, b.old_bounds, b.new_bounds,
            b.applied, b.feasible, b.moved_docs)
        for x, y in ((a.suffix_cost_old, b.suffix_cost_old),
                     (a.suffix_cost_new, b.suffix_cost_new)):
            assert x == y or abs(x - y) <= 1e-11 * abs(y)
    for ds_g, ds_c in zip(gpu._drift_states, cpu._drift_states):
        for f in t_drift.DriftState._fields:
            assert torch.equal(getattr(ds_g, f).cpu(), getattr(ds_c, f)), f
    np.testing.assert_array_equal(gpu.meter.boundaries, cpu.meter.boundaries)
    gt, ct = gpu.finalize_tiers(), cpu.finalize_tiers()
    for sid in ct:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(gt[sid][key], ct[sid][key])


# ---------------------------------------------------------------------------
# fleet observability (repro_torch.obs) on the card
# ---------------------------------------------------------------------------

def count_syncs(fn):
    """``fn()``'s result and the synchronizing CUDA operations it issued
    (``torch.cuda.set_sync_debug_mode("warn")`` warns once for each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def observed_mixed_engine(device, mesh=None):
    from repro_torch.obs import Observability, ObsConfig
    return mixed_engine(device, Observability(ObsConfig(costs=True)), mesh)


@pytest.mark.cuda
def test_obs_counters_and_ledgers_on_card_equal_cpu(cuda_device):
    """The mixed fleet (exact and logmem buckets, NaN and Inf scores in
    the second chunk) observed with costs on: the packed counters, the
    drift score's bits, every bucket's cost ledger, the snapshot and the
    cost summary equal the port's CPU run."""
    from repro_torch.obs import costs as costs_mod
    cpu, gpu = (observed_mixed_engine(d) for d in ("cpu", cuda_device))
    cpu.ingest_chunks(mixed_dense_chunks(12, 4))
    gpu.ingest_chunks(mixed_dense_chunks(12, 4))
    assert torch.equal(gpu._metrics_state.counts.cpu(),
                       cpu._metrics_state.counts)
    assert torch.equal(gpu._metrics_state.drift_score_max.cpu().view(
        torch.int32), cpu._metrics_state.drift_score_max.view(torch.int32))
    for cs, gs in zip(cpu._cost_states, gpu._cost_states):
        for a, b in zip(cs, gs):
            assert torch.equal(a, b.cpu())
    snap = gpu.obs_snapshot()
    assert snap["engine"]["scores_quarantined"] == 2
    assert json.dumps(snap, sort_keys=True) == json.dumps(
        cpu.obs_snapshot(), sort_keys=True)
    a, b = costs_mod.cost_summary(cpu), costs_mod.cost_summary(gpu)
    for key in ("writes", "reads", "storage", "migration", "total",
                "planned", "regret"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.cuda
def test_obs_adds_no_sync_on_card(cuda_device):
    """The same chunks through the mixed fleet with obs off and on (costs
    on), meter off: the steps issue the same number of synchronizing
    operations, and ``metrics.snapshot`` drains with one."""
    from repro_torch.obs import metrics as metrics_mod
    off = mixed_engine(cuda_device)
    on = observed_mixed_engine(cuda_device)
    # warm-up; a process's first counted call sees one synchronizing
    # operation whatever it drives, so the warm-up is counted too
    count_syncs(lambda: off.ingest_chunks(mixed_dense_chunks(2, 5),
                                          meter=False))
    on.ingest_chunks(mixed_dense_chunks(2, 5), meter=False)
    _, n_off = count_syncs(lambda: off.ingest_chunks(
        mixed_dense_chunks(8, 6), meter=False))
    _, n_on = count_syncs(lambda: on.ingest_chunks(
        mixed_dense_chunks(8, 6), meter=False))
    assert n_on == n_off
    snap, drains = count_syncs(lambda: metrics_mod.snapshot(
        on._metrics_state))
    assert drains == 1 and snap["chunks"] == 10
    for a, b in zip(off.states(), on.states()):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_cost_triggered_replanning_on_card_equals_cpu(cuda_device):
    """examples/cost_attribution.py's fleet (K=64, windows of 12,000,
    half the tenants with an 8x burst at doc 3000, cost trigger) on the
    card and on the CPU, from the card's planned boundaries, the CPU
    pinned to the card's re-solve: events in order (clock fields aside),
    replan events, cost alerts, cost summary and snapshots; the drift
    score within 1 ulp."""
    from repro_torch.obs import Observability, ObsConfig
    m, n, k = 8, 12000, 64
    wl = t_costs.WorkloadSpec(n_docs=n, k=k, doc_gb=1e-4, window_months=0.5)
    cm = t_costs.TwoTierCostModel(
        tier_a=t_costs.TierCosts("hot", put_per_doc=1e-6,
                                 get_per_doc=2.7e-4,
                                 storage_per_gb_month=0.05),
        tier_b=t_costs.TierCosts("cold", put_per_doc=8e-5,
                                 get_per_doc=1e-6,
                                 storage_per_gb_month=0.02),
        workload=wl)
    rng = np.random.default_rng(7)
    traces = np.stack([
        t_sim.drifted_rank_trace(n, rng, [(3000, 8.0)]) if i < m // 2
        else t_sim.random_rank_trace(n, rng)
        for i in range(m)]).astype(np.float32)
    chunks = [[(traces[:, c0:c0 + 64], np.tile(np.arange(
        c0, min(c0 + 64, n), dtype=np.int32), (m, 1)))]
        for c0 in range(0, n, 64)]
    cset = t_cons.ConstraintSet(t_cons.TierCapacity(0, 4 * k))
    cfg = t_replan.ReplanConfig(drift=t_drift.DriftConfig(alpha=1e-9))
    plan = t_eng.StreamEngine([t_eng.StreamSpec(stream_id=i, k=k,
                                                cost_model=cm)
                               for i in range(m)], constraints=cset,
                              device=cuda_device)
    specs = [t_eng.StreamSpec(stream_id=i, k=k, cost_model=cm,
                              boundaries=(float(plan.meter.boundaries[i, 0]),),
                              migrate=bool(plan.meter.migrate[i]))
             for i in range(m)]
    out = []
    for device in (cuda_device, "cpu"):
        obs = Observability(ObsConfig(costs=True, cost_trigger=True,
                                      cost_alpha=0.01))
        eng = t_eng.StreamEngine(specs, constraints=cset, replan=cfg,
                                 obs=obs, device=device)
        eng._replanner.backend = "device"
        eng.ingest_chunks(chunks)
        eng.finalize()
        out.append((eng, obs))
    (g, go), (c, co) = out
    assert [(e["kind"], e["name"], e["attrs"]) for e in go.tracer.events] \
        == [(e["kind"], e["name"], e["attrs"]) for e in co.tracer.events]
    assert any(e["name"] == "budget_burn" or e["name"] == "cost_alert"
               for e in go.tracer.events)
    assert [dataclasses.astuple(e) for e in g.replan_events] == \
        [dataclasses.astuple(e) for e in c.replan_events]
    assert g.cost_alerts() == c.cost_alerts()
    gs, cs = g.cost_summary(), c.cost_summary()
    for key in ("total", "planned", "regret"):
        np.testing.assert_array_equal(gs[key], cs[key])
    a, b = g.obs_snapshot(), c.obs_snapshot()
    np.testing.assert_array_max_ulp(
        np.float32(a["engine"].pop("drift_score_max")),
        np.float32(b["engine"].pop("drift_score_max")), maxulp=1)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)



# ---------------------------------------------------------------------------
# resilience on the card: snapshot/restore, the checkpoint hook, outage
# ---------------------------------------------------------------------------

def card_state(eng):
    """Every state leaf on the host, the meter's ledgers, assign_tiers."""
    out = [t.cpu() for st in eng.states() for t in st]
    out += [torch.from_numpy(v) for _, v in sorted(
        eng.meter.state_dict().items())]
    out += [t.cpu() for pair in eng.assign_tiers() if pair is not None
            for t in pair]
    return out


def assert_card_states_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_snapshot_restore_resume_on_card_equals_cpu(cuda_device):
    """The observed mixed fleet snapshotted on the card after 6 chunks,
    restored into a fresh card engine and resumed for 6 more: every
    state leaf, ledger and assign_tiers equal the CPU engine's
    uninterrupted run."""
    from repro_torch.resilience import fleet_restore, fleet_snapshot
    chunks = list(mixed_dense_chunks(12, 7))
    cpu = observed_mixed_engine("cpu")
    cpu.ingest_chunks(chunks)
    gpu = observed_mixed_engine(cuda_device)
    gpu.ingest_chunks(chunks[:6])
    tree, meta = fleet_snapshot(gpu)
    gpu2 = observed_mixed_engine(cuda_device)
    fleet_restore(gpu2, tree, meta)
    assert gpu2.chunks_ingested == 6
    gpu2.ingest_chunks(chunks[6:])
    assert_card_states_equal(card_state(cpu), card_state(gpu2))
    assert json.dumps(cpu.obs_snapshot(), sort_keys=True) == json.dumps(
        gpu2.obs_snapshot(), sort_keys=True)


@pytest.mark.cuda
def test_ingest_chunks_with_checkpointer_on_card(cuda_device, tmp_path):
    """The double-buffered ingest with an async checkpointer at every
    second chunk boundary gives the finals it gives without one, and
    the last checkpoint restores into a card engine equal to both."""
    from repro_torch.resilience import FleetCheckpointer
    chunks = list(mixed_dense_chunks(10, 8))
    plain, ckd = mixed_engine(cuda_device), mixed_engine(cuda_device)
    plain.ingest_chunks(chunks)
    ck = FleetCheckpointer(str(tmp_path), every=2)
    ckd.attach_checkpointer(ck)
    ckd.ingest_chunks(chunks)
    ck.wait()
    assert ck.written == 5 and ck.manager.latest_step() == 10
    want = card_state(plain)
    assert_card_states_equal(want, card_state(ckd))
    back = mixed_engine(cuda_device)
    ck.restore(back)
    assert_card_states_equal(want, card_state(back))


@pytest.mark.cuda
def test_tier_outage_on_card_equals_cpu(cuda_device):
    """examples/chaos_recovery.py's fleet (three tiers, half planned on
    the CPU's plan and half pinned, re-planning and costs on) through a
    tier-1 outage on the card and on the CPU: summaries, events, re-plan
    events, ledgers and assign_tiers equal."""
    from repro_torch.obs import Observability, ObsConfig
    from repro_torch.resilience import TierOutage
    n, m, w = 18 * 32, 64, 32
    models = [t_topo.hbm_dram_disk_preset(n_docs=n, k=8, doc_gb=1e-4,
                                          window_seconds=30.0 * (1 + t % 3))
              for t in range(m)]
    plan = t_eng.StreamEngine([t_eng.StreamSpec(stream_id=t, k=8,
                                                cost_model=cm)
                               for t, cm in enumerate(models)],
                              device="cpu")
    specs = [t_eng.StreamSpec(
        stream_id=t, k=8, cost_model=cm,
        boundaries=((32.0, n * 0.8) if t % 2
                    else tuple(plan.meter.boundaries[t].tolist())),
        migrate=bool(plan.meter.migrate[t]) and t % 2 == 0)
        for t, cm in enumerate(models)]

    def chunk(i):
        r = np.random.default_rng(i)
        s = r.random((m, w)).astype(np.float32)
        if i >= 4:
            s[: m // 2] += 0.5
        return [(s, np.tile(np.arange(i * w, (i + 1) * w, dtype=np.int32),
                            (m, 1)))]

    out = []
    for device in (cuda_device, "cpu"):
        obs = Observability(ObsConfig(costs=True))
        eng = t_eng.StreamEngine(
            specs, obs=obs, device=device,
            replan=t_replan.ReplanConfig(drift=t_drift.DriftConfig(
                alpha=0.05)))
        eng._replanner.backend = "device"
        eng.ingest_chunks([chunk(i) for i in range(12)])
        with TierOutage(eng, tier=1, hysteresis=2) as drill:
            eng.ingest_chunks([chunk(i) for i in range(12, 15)])
            assert eng.meter.occupancy[:, 1].sum() == 0
        eng.ingest_chunks([chunk(i) for i in range(15, 18)])
        out.append((eng, obs, drill.summary))
    (g, go, gsum), (c, co, csum) = out
    assert gsum == csum and gsum["rows_evacuated"] > 0
    assert [(e["kind"], e["name"], e["attrs"]) for e in go.tracer.events] \
        == [(e["kind"], e["name"], e["attrs"]) for e in co.tracer.events]
    assert [dataclasses.astuple(e) for e in g.replan_events] == \
        [dataclasses.astuple(e) for e in c.replan_events]
    assert_card_states_equal(card_state(g), card_state(c))
    gs, cs = g.cost_summary(), c.cost_summary()
    for key in ("total", "planned", "regret"):
        np.testing.assert_array_equal(gs[key], cs[key])


# ---------------------------------------------------------------------------
# fleet-axis sharding on the card: 8 shards on one card
# ---------------------------------------------------------------------------

def card_mesh(device, shards=8):
    from repro_torch.parallel import fleet
    return fleet.fleet_mesh(shards, device=device)


@pytest.mark.cuda
def test_sharded_engine_on_card_equals_unsharded(cuda_device):
    """The observed mixed fleet with 8 shards on the card (2 exact rows a
    shard; the 4 logmem tenants padded to 8 rows) against the unsharded
    card engine over the same double-buffered chunks: every state leaf,
    ledger, assign_tiers, the snapshot, bit for bit; each scan kernel
    launched once a shard and chunk, tier_assign once a shard."""
    plain = observed_mixed_engine(cuda_device)
    shd = observed_mixed_engine(cuda_device, card_mesh(cuda_device))
    assert shd._shards == 8
    plain.ingest_chunks(mixed_dense_chunks(12, 4))
    b0, l0 = t_btk.launches, t_lm_ops.launches
    assert shd.ingest_chunks(mixed_dense_chunks(12, 4)) == 12
    assert (t_btk.launches - b0, t_lm_ops.launches - l0) == (96, 96)
    want = card_state(plain)
    a0 = t_ta.launches
    got = card_state(shd)
    assert t_ta.launches - a0 == 8
    assert_card_states_equal(want, got)
    assert json.dumps(plain.obs_snapshot(), sort_keys=True) == json.dumps(
        shd.obs_snapshot(), sort_keys=True)


@pytest.mark.cuda
@pytest.mark.parametrize("constrained", [False, True])
def test_sharded_plan_on_card_equals_unsharded(constrained, cuda_device):
    """A 3-tier fleet of 4,099 streams planned on the card with 8 shards
    (plan_solve launched per shard) equals the unsharded device plan bit
    for bit."""
    from repro_torch.parallel import fleet
    rng = np.random.default_rng(25)
    m = 4099
    args = (rng.uniform(0.5, 2.0, (m, 3)), rng.uniform(0.1, 1.0, (m, 3)),
            rng.uniform(0.01, 0.2, (m, 3)),
            rng.integers(50, 400, m).astype(np.float64),
            rng.integers(2, 16, m).astype(np.float64),
            rng.uniform(0.5, 4.0, m))
    kw = {}
    if constrained:
        cap = np.full((m, 3), np.inf)
        cap[:, 0] = rng.uniform(20, 80, m)
        kw = dict(cap=cap, lat=rng.uniform(0.1, 1.0, (m, 3)),
                  slo=np.where(rng.random(m) < 0.3,
                               rng.uniform(0.5, 2.0, m), np.inf))
    p0 = t_ps.launches
    ref = t_shp.plan_ntier_arrays(*args, backend="device",
                                  device=cuda_device, **kw)
    n_plain = t_ps.launches - p0
    with fleet.use_fleet_mesh(card_mesh(cuda_device)):
        out = t_shp.plan_ntier_arrays(*args, backend="device", **kw)
    assert t_ps.launches - p0 - n_plain == 8 * n_plain > 0
    for key in ("total", "bounds", "migrate"):
        np.testing.assert_array_equal(ref[key], out[key], err_msg=key)


@pytest.mark.cuda
def test_sharded_resolve_and_waterfill_on_card(cuda_device):
    """The device re-solve with its rows split over 8 shards on the card
    equals the unsharded re-solve; the sharded water-filling on the card
    meets the host law within the reference's tolerances and never
    oversubscribes."""
    from repro_torch.core import constraints as cons
    from repro_torch.parallel import fleet
    rng = np.random.default_rng(2)
    r = 203
    cw, cr, cs = (rng.uniform(lo, hi, (r, 3))
                  for lo, hi in ((0.5, 2.0), (0.1, 1.0), (0.01, 0.2)))
    n = rng.integers(50, 400, r).astype(np.float64)
    k = rng.integers(2, 16, r).astype(np.float64)
    cap = np.full((r, 3), np.inf)
    cap[:, 0] = rng.uniform(20, 80, r)
    args = (cw, cr, cs, n, k, rng.uniform(0.5, 4.0, r), cap,
            rng.uniform(0.1, 1.0, (r, 3)), np.full(r, np.inf),
            np.minimum(n * 0.5, n - 1), rng.uniform(0.5, 1.5, r),
            np.sort(rng.uniform(0, 1, (r, 2)), axis=1) * n[:, None])
    ref = t_rd.solve_group(*args, device=cuda_device)
    mesh = card_mesh(cuda_device)
    with fleet.use_fleet_mesh(mesh):
        out = t_rd.solve_group(*args)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    desired = rng.uniform(0.0, 50.0, 1001)
    desired[rng.random(1001) < 0.2] = 0.0
    for frac in (0.3, 0.9, 1.2):
        budget = float(desired.sum() * frac)
        grants = fleet.waterfill_sharded(desired, budget, mesh)
        assert (grants <= desired + 1e-9).all()
        assert grants.sum() <= budget * (1 + 1e-12) + 1e-9
        np.testing.assert_allclose(grants,
                                   cons.waterfill_grants(desired, budget),
                                   rtol=1e-7, atol=1e-7)


@pytest.mark.cuda
def test_sharded_engine_across_cards_equals_unsharded(cuda_device):
    """With two or more cards visible, ``fleet_mesh()`` puts one shard on
    each: the observed mixed fleet, the plan and the water-filling across
    the cards equal the unsharded run on one card, and ``serve --mesh N``
    shards the tenant engine over the N cards with the unsharded run's
    retained sets."""
    import os
    import subprocess
    import sys
    from repro_torch.core import constraints as cons
    from repro_torch.parallel import fleet
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA cards")
    mesh = fleet.fleet_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(cards))
    plain = observed_mixed_engine(cuda_device)
    shd = observed_mixed_engine(cuda_device, mesh)
    assert [p.ids.device for p in shd._states[0]] == list(mesh.devices)
    plain.ingest_chunks(mixed_dense_chunks(12, 4))
    shd.ingest_chunks(mixed_dense_chunks(12, 4))
    assert_card_states_equal(card_state(plain), card_state(shd))
    assert json.dumps(plain.obs_snapshot(), sort_keys=True) == json.dumps(
        shd.obs_snapshot(), sort_keys=True)
    rng = np.random.default_rng(5)
    m = 1001
    args = (rng.uniform(0.5, 2.0, (m, 3)), rng.uniform(0.1, 1.0, (m, 3)),
            rng.uniform(0.01, 0.2, (m, 3)),
            rng.integers(50, 400, m).astype(np.float64),
            rng.integers(2, 16, m).astype(np.float64),
            rng.uniform(0.5, 4.0, m))
    ref = t_shp.plan_ntier_arrays(*args, backend="device", device=cuda_device)
    with fleet.use_fleet_mesh(mesh):
        out = t_shp.plan_ntier_arrays(*args, backend="device")
    for key in ("total", "bounds", "migrate"):
        np.testing.assert_array_equal(ref[key], out[key], err_msg=key)
    desired = rng.uniform(0.0, 50.0, m)
    budget = float(desired.sum() * 0.5)
    grants = fleet.waterfill_sharded(desired, budget, mesh)
    assert grants.sum() <= budget * (1 + 1e-12) + 1e-9
    np.testing.assert_allclose(grants, cons.waterfill_grants(desired, budget),
                               rtol=1e-7, atol=1e-7)
    env = {**os.environ, "PYTHONPATH": "src"}
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cuda", "--tenants", "8", "--requests", "64", "--batch", "8"]
    runs = [subprocess.run(argv + extra, capture_output=True, text=True,
                           env=env, timeout=600)
            for extra in (["--mesh", str(cards)], [])]
    for run in runs:
        assert run.returncode == 0, run.stderr[-3000:]
    assert f"fleet mesh: {cards} shards on {cards} cards" in runs[0].stdout

    def kept(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("tenant ", "fleet ledger"))]

    assert kept(runs[0].stdout) == kept(runs[1].stdout) != []


# ---------------------------------------------------------------------------
# training on the card: flash_attention's backward pair, FlashAttentionFn,
# the train step
# ---------------------------------------------------------------------------

# FA_CASES and the backward's seams: groups of 1, 4 and 12, head dims 16
# to 128, Sq and Skv off multiples of 64, batch 1, windows, Sq > Skv with
# rows whose keys are all masked; at batch 1 and one or two KV heads
# backward_plan splits the whole group (g 12 over KV 1 and 2, a ragged Skv
# at head dim 128), and at (5, 1024, 16 over 2) into 4 parts of 2 heads
FA_BWD_CASES = FA_CASES + [(1, 90, 33, 4, 4, 16, True, 0),
                           (1, 90, 33, 8, 2, 32, True, 7),
                           (1, 77, 77, 12, 1, 16, False, 9),
                           (1, 130, 130, 24, 2, 128, True, 0),
                           (1, 70, 24, 4, 1, 128, True, 0),
                           (2, 100, 257, 4, 4, 64, True, 50),
                           (1, 200, 200, 12, 1, 64, True, 0),
                           (1, 256, 256, 24, 2, 128, True, 0),
                           (1, 100, 333, 12, 1, 128, True, 0),
                           (5, 1024, 1024, 16, 2, 64, True, 0)]
# grids the plan leaves unsplit with long dK/dV sums: 8 heads of 4096
# queries at head dim 64 (576 blocks), 6 heads of 2048 at 128 (576)
FA_BWD_LONG = [(9, 4096, 4096, 8, 1, 64, True, 0),
               (9, 2048, 2048, 24, 4, 128, True, 0)]


def _bwd_inputs(b, sq, skv, h, kvh, hd, dtype, device):
    rng = np.random.default_rng(sq * 7 + skv)
    q, k, v = (torch.tensor(x, device=device).to(dtype)
               for x in fa_case(b, sq, skv, h, kvh, hd, sq + skv))
    dout = torch.tensor(rng.standard_normal(q.shape), device=device).to(dtype)
    return q, k, v, dout


def _check_backward(case, dtype, device):
    """The backward against reference_backward: float32 within 1e-4 of
    each plain gradient's largest magnitude, bfloat16 within 2e-2; the
    forward's log-sum-exp within 2e-5 of reference_lse."""
    b, sq, skv, h, kvh, hd, causal, window = case
    q, k, v, dout = _bwd_inputs(b, sq, skv, h, kvh, hd, dtype, device)
    kw = dict(causal=causal, window=window)
    out, lse = t_fa.forward_with_lse(q, k, v, **kw)
    before = t_fa.bwd_launches
    got = t_fa.backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert t_fa.bwd_launches == before + 1
    torch.testing.assert_close(lse, t_fa.reference_lse(q, k, v, **kw),
                               rtol=2e-5, atol=2e-5)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(got, t_fa.reference_backward(q, k, v, out, lse, dout,
                                                 **kw)):
        assert a.shape == r.shape and a.dtype == r.dtype == dtype
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", FA_BWD_CASES)
def test_flash_attention_backward_kernel_equals_plain(b, sq, skv, h, kvh, hd,
                                                      causal, window, dtype,
                                                      cuda_device):
    """The backward under backward_plan against reference_backward."""
    _check_backward((b, sq, skv, h, kvh, hd, causal, window), dtype,
                    cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_BWD_LONG)
def test_flash_attention_backward_long_sums_equal_plain(case, dtype,
                                                        cuda_device):
    """Long dK/dV sums in one block, where the plan leaves the group
    unsplit, against reference_backward."""
    b, sq, skv, h, kvh, hd, _, _ = case
    assert t_fa.backward_plan(b, h, kvh, sq, skv, hd)["split"] == 1
    _check_backward(case, dtype, cuda_device)


def _f64_gap(grads, g64):
    """dq, dk and dv's largest absolute difference from the float64 plain
    route's over its largest magnitude; then the key-bias residue, the
    largest |sum of dk over the keys| of a batch row, KV head and dim over
    dk's largest float64 magnitude (the key bias's exact gradient is 0:
    each row of dS sums to 0)."""
    gap = [float((a.double() - w).abs().max() / w.abs().max())
           for a, w in zip(grads, g64)]
    return gap + [float(grads[1].double().sum(dim=1).abs().max()
                        / g64[1].abs().max())]


@pytest.mark.cuda
def test_flash_attention_backward_float64_witness(cuda_device):
    """The float32 kernel route's backward at a non-causal shape with 1024
    keys behind a key bias (whisper-base's attention carries one) against
    a float64 plain route: dq, dk and dv at most 3 times as far from it
    as the float32 plain route's (reference, reference_lse,
    reference_backward), and the key-bias residue at most 3 times the
    float32 plain route's. Where Delta = rowsum(dO * O) comes from the
    forward's output and O or dQ sum over the keys in one tensor-core
    accumulator, the residue comes out orders of magnitude larger."""
    b, sq, skv, h, kvh, hd = 2, 256, 1024, 4, 4, 64
    rng = np.random.default_rng(34)
    q, k, v, dout = (torch.tensor(rng.standard_normal(shape),
                                  device=cuda_device, dtype=torch.float32)
                     for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                                   (b, skv, kvh, hd), (b, sq, h, hd)))
    k = k + torch.tensor(rng.standard_normal(hd), device=cuda_device,
                         dtype=torch.float32)
    kw = dict(causal=False)
    out, lse = t_fa.forward_with_lse(q, k, v, **kw)
    kernel = t_fa.backward(q, k, v, out, lse, dout, **kw)

    def plain(dtype):
        xs = [x.to(dtype) for x in (q, k, v, dout)]
        o = t_fa.reference(*xs[:3], **kw)
        return t_fa.reference_backward(
            *xs[:3], o, t_fa.reference_lse(*xs[:3], **kw), xs[3], **kw)

    g64 = plain(torch.float64)
    got, want = _f64_gap(kernel, g64), _f64_gap(plain(torch.float32), g64)
    for name, a, w in zip(("dq", "dk", "dv", "key-bias residue"), got, want):
        assert a <= 3 * w, (name, a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("llama3.2-1b", 1024, 32, 8, 64, 64, 0.0),
    ("grok-1 capped", 1024, 48, 8, 128, 128, 30.0),
    ("deepseek-v2", 1024, 128, 128, 192, 128, 0.0)])
def test_flash_attention_forward_float64_witness(case, cuda_device):
    """The float32 forward kernel's output at three prefill shapes cut to
    one batch row (causal; llama3.2-1b's, grok-1's capped at 30 and
    deepseek-v2's at head dims (192, 128)) against a float64 plain route:
    its largest difference at most 3 times the float32 plain route's
    (FA_F64_RATIO in chip_smoke.py). The tensor cores truncate inside a
    sum; a product carried in one accumulator over every key or the whole
    head dim lies further from float64 than the plain route."""
    _, s, h, kvh, hd, hd_v, cap = case
    rng = np.random.default_rng(hd + h)
    q, k, v = (torch.tensor(rng.standard_normal(shape), device=cuda_device,
                            dtype=torch.float32)
               for shape in ((1, s, h, hd), (1, s, kvh, hd),
                             (1, s, kvh, hd_v)))
    kw = dict(causal=True, softcap=cap)
    out = t_fa.flash_attention(q, k, v, **kw)
    o64 = t_fa.reference(*(x.double() for x in (q, k, v)), **kw)
    top = o64.abs().max()
    got = float((out.double() - o64).abs().max() / top)
    want = float((t_fa.reference(q, k, v, **kw).double() - o64).abs().max()
                 / top)
    assert got <= 3 * want, (case[0], got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,split", [
    ((3, 2048, 2048, 16, 8, 64, True, 0), 1),
    ((2, 300, 300, 32, 8, 64, True, 0), 4),
    ((5, 1024, 1024, 16, 2, 64, True, 0), 4),
    ((1, 130, 130, 24, 2, 128, True, 0), 12),
    ((1, 100, 333, 12, 1, 128, True, 0), 12)])
def test_flash_attention_backward_is_deterministic(case, split, dtype,
                                                   cuda_device):
    """No atomics: two backward calls agree bit for bit, with the group
    unsplit and split, as the plan says."""
    b, sq, skv, h, kvh, hd, causal, window = case
    assert t_fa.backward_plan(b, h, kvh, sq, skv, hd)["split"] == split
    q, k, v, dout = _bwd_inputs(b, sq, skv, h, kvh, hd, dtype, cuda_device)
    out, lse = t_fa.forward_with_lse(q, k, v)
    first = t_fa.backward(q, k, v, out, lse, dout)
    again = t_fa.backward(q, k, v, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window",
                         [(2, 96, 96, 8, 2, 64, True, 0),
                          (1, 70, 40, 4, 1, 32, True, 5),
                          (1, 65, 65, 12, 1, 128, False, 0)])
def test_flash_attention_autograd_equals_plain_route(b, sq, skv, h, kvh, hd,
                                                     causal, window,
                                                     cuda_device):
    """flash_attention with inputs that require grad runs
    FlashAttentionFn (one forward and one backward launch); its output
    and gradients equal autograd through the plain version within 2e-5
    and 1e-4 of each gradient's largest magnitude."""
    kw = dict(causal=causal, window=window)
    base = [torch.tensor(x, device=cuda_device)
            for x in fa_case(b, sq, skv, h, kvh, hd, 11)]
    grads = []
    for route in (t_fa.flash_attention, t_fa.reference):
        xs = [x.clone().requires_grad_(True) for x in base]
        n0, b0 = t_fa.launches, t_fa.bwd_launches
        out = route(*xs, **kw)
        (out.square() * 0.5).sum().backward()
        torch.cuda.synchronize()
        if route is t_fa.flash_attention:
            assert out.grad_fn is not None
            assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == (1, 1)
            kernel_out = out.detach()
        else:
            torch.testing.assert_close(kernel_out, out.detach(), rtol=2e-5,
                                       atol=2e-5)
        grads.append([x.grad for x in xs])
    for a, r in zip(*grads):
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.cuda
def test_flash_attention_dispatch_without_grad(cuda_device):
    """No input requiring grad, or grad disabled: the forward launch alone,
    and the output carries no graph."""
    q, k, v = (torch.tensor(x, device=cuda_device)
               for x in fa_case(1, 64, 64, 4, 2, 32, 3))
    n0, b0 = t_fa.launches, t_fa.bwd_launches
    out = t_fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        out2 = t_fa.flash_attention(qg, k, v)
    assert out2.grad_fn is None
    assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == (2, 0)
    torch.testing.assert_close(out, out2)


def _state_to(state, device):
    from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(state)
    return tree_unflatten(treedef, [x.to(device, copy=True) for x in leaves])


@pytest.mark.cuda
def test_train_step_on_card_equals_cpu(cuda_device):
    """The reduced llama3.2-1b train_step on the card (flash_attention and
    its backward in every layer) against the CPU from the same state and
    batch: loss, NLL and grad_norm within 1e-5 relative, gradients within
    1e-4 of each leaf's largest magnitude, the reservoir's ids equal."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = t_configs.get_config("llama3.2-1b", reduced=True)
    cpu = steps.init_train_state(cfg, seed=0, reservoir_k=16, device="cpu")
    loader = StreamLoader(cfg, ShapeConfig("t", seq_len=64, global_batch=8,
                                           kind="train"), seed=0)
    for step in range(2):
        card = _state_to(cpu, cuda_device)
        host = loader.batch_for_step(step)
        b_cpu = {k: torch.as_tensor(x) for k, x in host.items()}
        b_card = {k: torch.as_tensor(x, device=cuda_device)
                  for k, x in host.items()}
        _, _, g_cpu = steps.loss_and_grads(cpu.params, cfg, b_cpu)
        n0, b0 = t_fa.launches, t_fa.bwd_launches
        _, _, g_card = steps.loss_and_grads(card.params, cfg, b_card)
        assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == \
            (cfg.n_layers, cfg.n_layers)
        for a, w in zip(adamw.tree_leaves(g_card), adamw.tree_leaves(g_cpu)):
            top = float(w.abs().max())
            assert top > 0
            assert float((a.cpu() - w).abs().max()) <= 1e-4 * top
        nxt, m_cpu = steps.train_step(cpu, b_cpu, cfg)
        card, m_card = steps.train_step(card, b_card, cfg)
        for key in ("loss", "per_example_nll", "grad_norm"):
            np.testing.assert_allclose(m_card[key].cpu().numpy(),
                                       m_cpu[key].numpy(), rtol=1e-5)
        torch.testing.assert_close(card.reservoir.ids.cpu(),
                                   nxt.reservoir.ids)
        cpu = nxt


# ---------------------------------------------------------------------------
# soft-capped flash_attention and the MoE score producer (grok-1-314b)
# ---------------------------------------------------------------------------

# (b, sq, skv, h, kvh, hd, causal, window, softcap, q scale): grok-1's
# heads (48 over 8, head dim 128) at cap 30; a ragged windowed case where
# a cap of 5 bites hard (logits up to ~±50); Sq < Skv; rows with no key
FA_CAP_CASES = [(1, 256, 256, 48, 8, 128, True, 0, 30.0, 1.0),
                (1, 300, 300, 6, 2, 64, True, 100, 5.0, 8.0),
                (2, 100, 333, 4, 1, 128, True, 0, 5.0, 8.0),
                (1, 96, 96, 4, 4, 32, False, 0, 2.0, 4.0),
                (1, 40, 24, 2, 1, 16, True, 0, 5.0, 4.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window,cap,qs",
                         FA_CAP_CASES)
def test_flash_attention_softcap_equals_plain(b, sq, skv, h, kvh, hd, causal,
                                              window, cap, qs, dtype,
                                              cuda_device):
    """The capped kernel against its plain version (cap before the mask):
    output within 2e-5 in float32 and 2e-2 in bfloat16, the row
    log-sum-exp of the capped logits within the same, one launch a
    call."""
    q, k, v = (torch.tensor(x, device=cuda_device)
               for x in fa_case(b, sq, skv, h, kvh, hd, sq + skv + 3))
    q, k, v = (q * qs).to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = t_fa.launches
    out = t_fa.flash_attention(q, k, v, **kw)
    o2, lse = t_fa.forward_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 2
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    ref = t_fa.reference(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(out, o2)
    torch.testing.assert_close(lse, t_fa.reference_lse(q, k, v, **kw),
                               rtol=tol, atol=tol)


# the capped backward's cases (FA_CAP_CASES' masks and heads) at the
# capped build's head dims 16, 32, 64 and 128: (b, sq, skv, h, kvh, hd,
# causal, window, softcap, q scale)
FA_CAP_BWD_CASES = FA_CAP_CASES + [(2, 130, 130, 4, 2, 16, True, 0, 30.0,
                                    1.0),
                                   (1, 90, 33, 4, 1, 32, True, 7, 5.0, 8.0),
                                   (1, 100, 100, 24, 2, 128, True, 0, 5.0,
                                    8.0)]


def _check_capped_backward(case, dtype, device):
    """ops.backward of a soft-capped forward against reference_backward
    (float32 within 1e-4 of each gradient's largest magnitude, bfloat16
    2e-2), a second call bit-equal; returns the inputs and gradients."""
    b, sq, skv, h, kvh, hd, causal, window, cap, qs = case
    rng = np.random.default_rng(sq * 5 + skv + hd)
    q, k, v = (torch.tensor(x, device=device)
               for x in fa_case(b, sq, skv, h, kvh, hd, sq + skv + 3))
    q, k, v = (q * qs).to(dtype), k.to(dtype), v.to(dtype)
    dout = torch.tensor(rng.standard_normal(q.shape), device=device).to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = t_fa.forward_with_lse(q, k, v, **kw)
    before = t_fa.bwd_launches
    got = t_fa.backward(q, k, v, out, lse, dout, **kw)
    again = t_fa.backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert t_fa.bwd_launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(got, t_fa.reference_backward(q, k, v, out, lse, dout,
                                                 **kw)):
        assert a.shape == r.shape and a.dtype == r.dtype == dtype
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), err
    return (q, k, v), got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CAP_BWD_CASES)
def test_flash_attention_capped_backward_equals_plain(case, dtype,
                                                      cuda_device):
    """The backward of a soft-capped forward (the capped build of both
    launches: dS times 1 − t²) against reference_backward(softcap=), with
    caps of 30, 5 and 2 that bite, at head dims 16 to 128."""
    _check_capped_backward(case, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [FA_CAP_CASES[0], FA_CAP_CASES[4]])
def test_flash_attention_capped_autograd_equals_plain_route(case,
                                                            cuda_device):
    """flash_attention with a cap and inputs that require grad runs
    FlashAttentionFn (one forward and one backward launch, no fallback);
    its gradients equal autograd through the capped plain version within
    1e-4 of each gradient's largest magnitude."""
    b, sq, skv, h, kvh, hd, causal, window, cap, qs = case
    kw = dict(causal=causal, window=window, softcap=cap)
    base = [torch.tensor(x, device=cuda_device)
            for x in fa_case(b, sq, skv, h, kvh, hd, 13)]
    base[0] = base[0] * qs
    grads = []
    for route in (t_fa.flash_attention, t_fa.reference):
        xs = [x.clone().requires_grad_(True) for x in base]
        n0, b0 = t_fa.launches, t_fa.bwd_launches
        (route(*xs, **kw).square() * 0.5).sum().backward()
        torch.cuda.synchronize()
        if route is t_fa.flash_attention:
            assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == (1, 1)
        grads.append([x.grad for x in xs])
    for a, r in zip(*grads):
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("factor,shape", [(2.0, (2, 24)), (1.25, (3, 21))])
def test_moe_forward_on_card_equals_cpu(factor, shape, cuda_device):
    """Reduced grok-1's MoE layer on the card (routing, dispatch and
    combine as plain tensor operations, the experts as batched products)
    against the CPU's: the same routes, output and aux within 2e-5;
    dropless and with drops and a padded group."""
    from repro_torch.models import ffn
    cfg = t_configs.get_config("grok-1-314b", reduced=True).replace(
        capacity_factor=factor)
    p = ffn.moe_params(torch.Generator().manual_seed(1), cfg, torch.float32)
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32))
    y, aux = ffn.moe_forward(p, x, cfg)
    yc, auxc = ffn.moe_forward(params_to(p, cuda_device), x.to(cuda_device),
                               cfg)
    torch.testing.assert_close(yc.cpu(), y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(auxc.cpu(), aux, rtol=2e-5, atol=2e-5)
    logits = torch.randn((2, 16, cfg.n_experts), generator=torch.Generator(
        ).manual_seed(3))
    torch.testing.assert_close(
        ffn.moe_dispatch(logits.to(cuda_device), 2, 6, True).cpu(),
        ffn.moe_dispatch(logits, 2, 6, True), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_serve_moe_on_card_equals_cpu(cuda_device):
    """Reduced grok-1-314b served on the card (capped flash_attention in
    each prefill layer, the MoE as plain tensor operations, entropy_scores
    per decode step) against the CPU's run with the same weights: exact
    launch counts, tokens equal, scores within 2e-5, retention equal."""
    cfg = t_configs.get_config("grok-1-314b", reduced=True)
    cpu = t_lm.init_params(cfg, seed=0, device="cpu")
    run = dict(requests=24, batch=8, prompt_len=8, gen_len=6, topk=8)
    t_fa.launches = t_ent.launches = 0
    res = t_serve.serve(cfg, params_to(cpu, cuda_device), device=cuda_device,
                        **run)
    assert (t_fa.launches, t_ent.launches) == (cfg.n_layers * 3, 5 * 3)
    ref = t_serve.serve(cfg, cpu, device="cpu", **run)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=2e-5, atol=2e-5)
    assert np.diff(np.sort(ref.scores)).min() > 4e-5
    assert res.retained == ref.retained
    assert res.store.ledger.as_dict() == ref.store.ledger.as_dict()


# keys past one KV_CHUNK of chunked_attention's scan (b, sq, skv, h, kvh,
# hd, window, softcap, q scale): phase 3's 4096-key window over 4608 keys
# and its capped case over three chunks
FA_LONG_CASES = [(1, 4608, 4608, 8, 2, 128, 4096, 0.0, 1.0),
                 (1, 1300, 1300, 4, 2, 64, 0, 5.0, 8.0),
                 (1, 700, 2200, 8, 2, 128, 1500, 5.0, 8.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,window,cap,qs", FA_LONG_CASES)
def test_flash_attention_long_keys_equal_chunked_attention(
        b, sq, skv, h, kvh, hd, window, cap, qs, cuda_device):
    """The kernel's long-key cases against the model's chunked_attention
    (the reference's scan over key chunks) on the card, float32 within
    2e-5."""
    from repro_torch.models import attention as t_attn
    q, k, v = (torch.tensor(x, device=cuda_device)
               for x in fa_case(b, sq, skv, h, kvh, hd, skv + 7))
    q = q * qs
    kw = dict(causal=True, window=window, softcap=cap)
    before = t_fa.launches
    out = t_fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1
    qp = torch.arange(skv - sq, skv, device=cuda_device).expand(b, sq)
    kp = torch.arange(skv, device=cuda_device).expand(b, skv)
    torch.testing.assert_close(
        out, t_attn.chunked_attention(q, k, v, qp, kp, **kw), rtol=2e-5,
        atol=2e-5)


# ---------------------------------------------------------------------------
# flash_attention at unequal head dims and the MLA score producer
# (deepseek-v2-236b)
# ---------------------------------------------------------------------------

# (b, sq, skv, h, hd, hd_v, causal, window): deepseek's pair (192, 128) at
# 128 heads causal, ragged Sq < Skv, and rows with no key; the reduced
# config's (24, 16) windowed
FA_MLA_CASES = [(1, 256, 256, 128, 192, 128, True, 0),
                (2, 100, 333, 4, 192, 128, True, 0),
                (1, 40, 24, 2, 192, 128, True, 0),
                (2, 70, 70, 4, 24, 16, True, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hd,hd_v,causal,window", FA_MLA_CASES)
def test_flash_attention_unequal_head_dims_equal_plain(
        b, sq, skv, h, hd, hd_v, causal, window, dtype, cuda_device):
    """The kernel at (q/k, v) head dims (192, 128) and (24, 16) against its
    plain version: output (B, Sq, H, hd_v) within 2e-5 in float32 and 2e-2
    in bfloat16, the row log-sum-exp within the same, one launch a call."""
    rng = np.random.default_rng(sq + skv + hd)
    q, k, v = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device=cuda_device).to(dtype)
               for shape in ((b, sq, h, hd), (b, skv, h, hd),
                             (b, skv, h, hd_v)))
    kw = dict(causal=causal, window=window, scale=hd ** -0.5)
    before = t_fa.launches
    out = t_fa.flash_attention(q, k, v, **kw)
    o2, lse = t_fa.forward_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 2
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    ref = t_fa.reference(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == ref.shape == (b, sq, h, hd_v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(out, o2)
    torch.testing.assert_close(lse, t_fa.reference_lse(q, k, v, **kw),
                               rtol=tol, atol=tol)


# (b, sq, skv, h, hd, hd_v, causal, window) of the backward at MLA's
# pairs: FA_MLA_CASES, deepseek's heads split by backward_plan at batch 1
# (one head a KV head: no split), and a grouped (24, 16) call whose group
# the plan splits
FA_MLA_BWD_CASES = FA_MLA_CASES + [(2, 130, 130, 4, 24, 16, False, 0)]


def _mla_inputs(b, sq, skv, h, hd, hd_v, dtype, device, kvh=None):
    rng = np.random.default_rng(sq + skv + hd)
    kvh = kvh or h
    return [torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         device=device).to(dtype)
            for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                          (b, skv, kvh, hd_v), (b, sq, h, hd_v))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hd,hd_v,causal,window",
                         FA_MLA_BWD_CASES)
def test_flash_attention_unequal_head_dims_backward_equals_plain(
        b, sq, skv, h, hd, hd_v, causal, window, dtype, cuda_device):
    """The backward at (q/k, v) head dims (192, 128) and (24, 16) against
    reference_backward: dq and dk at hd, dv at hd_v, float32 within 1e-4
    of each gradient's largest magnitude, bfloat16 2e-2; a second call
    bit-equal."""
    q, k, v, dout = _mla_inputs(b, sq, skv, h, hd, hd_v, dtype, cuda_device)
    kw = dict(causal=causal, window=window, scale=hd ** -0.5)
    out, lse = t_fa.forward_with_lse(q, k, v, **kw)
    got = t_fa.backward(q, k, v, out, lse, dout, **kw)
    again = t_fa.backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(got, t_fa.reference_backward(q, k, v, out, lse, dout,
                                                 **kw)):
        assert a.shape == r.shape and a.dtype == r.dtype == dtype
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), err


@pytest.mark.cuda
def test_flash_attention_unequal_head_dims_grouped_split_backward(
        cuda_device):
    """(24, 16) with 4 query heads over 1 KV head at batch 1: the plan
    splits the group into 4 parts, whose dK (24) and dV (16) partials the
    group sum adds in order; against reference_backward."""
    assert t_fa.backward_plan(1, 4, 1, 100, 100, 24, 16)["split"] == 4
    q, k, v, dout = _mla_inputs(1, 100, 100, 4, 24, 16, torch.float32,
                                cuda_device, kvh=1)
    out, lse = t_fa.forward_with_lse(q, k, v)
    got = t_fa.backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for a, r in zip(got, t_fa.reference_backward(q, k, v, out, lse, dout)):
        assert a.shape == r.shape
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.cuda
def test_flash_attention_mla_training_shape_backward(cuda_device):
    """deepseek-v2's training launch at a reduced batch and head count:
    q and k (2, 1024, 16, 192), v and dO (2, 1024, 16, 128), causal,
    float32 (the backward's largest layouts: 64 query rows a dq block over
    32-key tiles, 64 keys a dK/dV block over 32-query tiles) against
    reference_backward within 1e-4 of each gradient's largest magnitude;
    a second call bit-equal."""
    plan = t_fa.backward_plan(2, 16, 16, 1024, 1024, 192, 128)
    assert plan["split"] == 1 and plan["dq"]["tile_rows"] == 32
    q, k, v, dout = _mla_inputs(2, 1024, 1024, 16, 192, 128, torch.float32,
                                cuda_device)
    out, lse = t_fa.forward_with_lse(q, k, v)
    got = t_fa.backward(q, k, v, out, lse, dout)
    again = t_fa.backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for a, r in zip(got, t_fa.reference_backward(q, k, v, out, lse, dout)):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert float((a - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.cuda
def test_flash_attention_unequal_head_dims_cap_raises(cuda_device):
    """No capped build of MLA's pairs (no config has both): a capped call
    raises, and nothing falls back to the plain version; the autograd
    route at (192, 128) runs the kernels' backward."""
    q = torch.randn((1, 64, 2, 192), device=cuda_device)
    k = torch.randn((1, 64, 2, 192), device=cuda_device)
    v = torch.randn((1, 64, 2, 128), device=cuda_device)
    with pytest.raises(NotImplementedError, match="soft-cap"):
        t_fa.flash_attention(q, k, v, softcap=30.0)
    out, lse = t_fa.forward_with_lse(q, k, v)
    with pytest.raises(NotImplementedError, match="soft-cap"):
        t_fa.backward(q, k, v, out, lse, torch.ones_like(out), softcap=30.0)
    n0, b0 = t_fa.launches, t_fa.bwd_launches
    qg = q.clone().requires_grad_(True)
    t_fa.flash_attention(qg, k, v).sum().backward()
    torch.cuda.synchronize()
    assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == (1, 1)
    assert qg.grad.shape == q.shape and bool(qg.grad.abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-236b"])
def test_train_step_capped_and_mla_on_card_equals_cpu(arch, cuda_device):
    """Reduced grok-1-314b (soft-capped attention, MoE) and
    deepseek-v2-236b (MLA at (24, 16), MoE) train on the card: the
    gradients within 1e-4 of each leaf's largest magnitude of the CPU
    port's from the same state and batch, one flash_attention launch and
    one backward a layer; then a train_step each: loss, NLL and
    grad_norm within 1e-5 relative, the reservoir's ids equal (as
    test_train_step_on_card_equals_cpu holds llama3.2-1b)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = t_configs.get_config(arch, reduced=True)
    cpu = steps.init_train_state(cfg, seed=0, reservoir_k=16, device="cpu")
    loader = StreamLoader(cfg, ShapeConfig("t", seq_len=64, global_batch=8,
                                           kind="train"), seed=0)
    card = _state_to(cpu, cuda_device)
    host = loader.batch_for_step(0)
    b_cpu = {k: torch.as_tensor(x) for k, x in host.items()}
    b_card = {k: torch.as_tensor(x, device=cuda_device)
              for k, x in host.items()}
    _, _, g_cpu = steps.loss_and_grads(cpu.params, cfg, b_cpu)
    n0, b0 = t_fa.launches, t_fa.bwd_launches
    _, _, g_card = steps.loss_and_grads(card.params, cfg, b_card)
    assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == \
        (cfg.n_layers, cfg.n_layers)
    for a, w in zip(adamw.tree_leaves(g_card), adamw.tree_leaves(g_cpu)):
        top = float(w.abs().max())
        assert top > 0
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * top
    nxt, m_cpu = steps.train_step(cpu, b_cpu, cfg)
    card, m_card = steps.train_step(card, b_card, cfg)
    for key in ("loss", "per_example_nll", "grad_norm"):
        np.testing.assert_allclose(m_card[key].cpu().numpy(),
                                   m_cpu[key].numpy(), rtol=1e-5)
    torch.testing.assert_close(card.reservoir.ids.cpu(), nxt.reservoir.ids)


@pytest.mark.cuda
def test_serve_mla_on_card_equals_cpu(cuda_device):
    """Reduced deepseek-v2-236b served on the card (flash_attention at head
    dims (24, 16) in each prefill layer, the absorbed decode over the
    latent cache and the MoE as plain tensor operations, entropy_scores
    per decode step) against the CPU's run with the same weights: exact
    launch counts, tokens equal, scores within 2e-5, retention equal."""
    cfg = t_configs.get_config("deepseek-v2-236b", reduced=True)
    # seed 1: no two of the CPU's scores within twice the tolerance
    cpu = t_lm.init_params(cfg, seed=1, device="cpu")
    run = dict(requests=24, batch=8, prompt_len=8, gen_len=6, topk=8)
    t_fa.launches = t_ent.launches = 0
    res = t_serve.serve(cfg, params_to(cpu, cuda_device), device=cuda_device,
                        **run)
    assert (t_fa.launches, t_ent.launches) == (cfg.n_layers * 3, 5 * 3)
    ref = t_serve.serve(cfg, cpu, device="cpu", **run)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    np.testing.assert_allclose(res.scores, ref.scores, rtol=2e-5, atol=2e-5)
    assert np.diff(np.sort(ref.scores)).min() > 4e-5
    assert res.retained == ref.retained
    assert res.store.ledger.as_dict() == ref.store.ledger.as_dict()


# ---------------------------------------------------------------------------
# cross-attention, the encoder and the patch prefix (whisper-base,
# pixtral-12b)
# ---------------------------------------------------------------------------

# (b, sq, skv, h, kvh, hd, causal, window), every one non-causal with no
# window: whisper-base's encoder self-attention and its cross-attention at
# serving (416 decoder tokens) and training (448) over 1500 frames, at
# batch 2; a ragged Sq = Skv = 1500 over a group of 2; Sq > Skv (more
# decoder tokens than frames) at 90 x 33 and 300 x 77; the reduced
# config's cross shape
FA_XATTN_CASES = [(2, 1500, 1500, 8, 8, 64, False, 0),
                  (2, 416, 1500, 8, 8, 64, False, 0),
                  (2, 448, 1500, 8, 8, 64, False, 0),
                  (1, 1500, 1500, 8, 4, 64, False, 0),
                  (1, 90, 33, 4, 2, 64, False, 0),
                  (2, 300, 77, 8, 8, 64, False, 0),
                  (2, 12, 24, 4, 4, 16, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_XATTN_CASES)
def test_flash_attention_non_causal_equals_plain(case, dtype, cuda_device):
    """The forward at the new non-causal shapes against the plain version
    (2e-5 / 2e-2), then the log-sum-exp and the backward against
    reference_lse and reference_backward (1e-4 of each gradient's largest
    magnitude / 2e-2)."""
    test_flash_attention_kernel_equals_plain(*case, dtype, cuda_device)
    _check_backward(case, dtype, cuda_device)


def _encdec_batch(cfg, b, s, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)))}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.tensor(rng.standard_normal(
            (b, 24, cfg.d_model)), dtype=torch.float32)
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = torch.tensor(rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)), dtype=torch.float32)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_encdec_and_patch_prefix_on_card_equal_cpu(arch, cuda_device):
    """Reduced whisper-base (the encoder's 2 layers, the decoder's 2
    self- and 2 cross-attention layers on flash_attention) and
    pixtral-12b (the patch prefix) on the card against the CPU port with
    the same weights: the forward's logits, then prefill and 6 decode
    steps, within 2e-5; exact launches (whisper's prefill: 2 encoder, 2
    cross, 2 causal; none at decode); a train step's loss and gradients
    (the kernel's backward, non-causal in the encoder and the cross
    layers) within 1e-5 relative, and each gradient leaf within 1e-4 of
    its own largest magnitude (phase 17a's rule), the key bias ``bk``
    within 1e-4 of its value bias's: its exact gradient is 0 (the softmax
    removes a shift of every key), so both sides hold float noise."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    cfg = t_configs.get_config(arch, reduced=True)
    cpu = t_lm.init_params(cfg, seed=1, device="cpu")
    card = params_to(cpu, cuda_device)
    s = cfg.decoder_len if cfg.is_encoder_decoder else 20
    b_cpu = _encdec_batch(cfg, 2, s)
    b_card = {k: v.to(cuda_device) for k, v in b_cpu.items()}
    want, _ = t_lm.forward(cpu, cfg, b_cpu)
    got, _ = t_lm.forward(card, cfg, b_card)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
    enc = 24 if cfg.is_encoder_decoder else 0
    t0 = 10
    logits = []
    for params, batch, dev in ((cpu, b_cpu, "cpu"),
                               (card, b_card, cuda_device)):
        cache = t_lm.init_cache(cfg, 2, s + 1, device=dev, enc_len=enc)
        n0 = t_fa.launches
        out, cache = t_lm.prefill(params, cfg, dict(
            batch, tokens=batch["tokens"][:, :t0]), cache)
        launches = t_fa.launches - n0
        steps_out = [out]
        for t in range(t0, s):
            out, cache = t_lm.decode_step(params, cfg, batch["tokens"][:, t],
                                          cache)
            steps_out.append(out)
        logits.append(torch.stack(steps_out, 1).cpu())
    attn = sum(sp.count for sp in cfg.layers + cfg.encoder_layers)
    cross = sum(sp.count for sp in cfg.layers if sp.cross_attn)
    assert launches == attn + cross and t_fa.launches - n0 == launches
    torch.testing.assert_close(logits[1], logits[0], rtol=2e-5, atol=2e-5)
    b_cpu["labels"] = torch.roll(b_cpu["tokens"], -1, 1)
    b_card["labels"] = b_cpu["labels"].to(cuda_device)
    l_cpu, _, g_cpu = steps.loss_and_grads(cpu, cfg, b_cpu)
    n0, b0 = t_fa.launches, t_fa.bwd_launches
    l_card, _, g_card = steps.loss_and_grads(card, cfg, b_card)
    assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == (attn + cross,
                                                            attn + cross)
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-5)
    for path, a in _paths(g_card):
        w = _at(g_cpu, path)
        top = float(w.abs().max())
        if path[-1] == "bk":
            top = float(_at(g_cpu, path[:-1] + ("bv",)).abs().max())
            assert float(w.abs().max()) <= 1e-4 * top, path
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * top, path
    assert len(_paths(g_card)) == len(adamw.tree_leaves(g_cpu))


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [q for k in tree for q in _paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree) for q in _paths(v, path + (i,))]
    return [(path, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.cuda
def test_card_slice_count_scales_to_the_dry_run(cuda_device):
    """The per-chip slice of llama3.2-1b's train_4k (batch 1 x 4096,
    bfloat16, cfg.remat) on the card under op_count: its FLOPs x 256
    equal the dry run's global FLOPs within 1% (in fact exactly: every
    product scales with the batch), and equal the slice's own trace on
    meta; 32 forward and 16 backward flash_attention launches a step."""
    from repro_torch.launch import dryrun, inspect_cell
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", "single", verbose=False)
    n0, b0 = t_fa.launches, t_fa.bwd_launches
    res = inspect_cell.card_slice("llama3.2-1b", "train_4k", warm=1,
                                  timed=1, top=3)
    assert (t_fa.launches - n0, t_fa.bwd_launches - b0) == (4 * 32, 4 * 16)
    glob = rec["roofline"]["detail"]["global_flops"]
    assert abs(res["count"]["flops"] * res["scale"] / glob - 1) < 0.01
    shape = t_configs.get_shape("train_4k")
    cfg = dryrun.cell_config("llama3.2-1b", shape, "single")
    sl, _ = inspect_cell.slice_shape(shape, 256)
    oc, _, _ = dryrun.trace(cfg.replace(seq_parallel=False), sl)
    assert oc.flops == res["count"]["flops"]
    assert res["median_ms"] > 0 and len(res["top_kernels"]) == 3


@pytest.mark.cuda
def test_compressed_psum_on_card_equals_cpu(cuda_device):
    """Two shards on the card, 8 rounds of error feedback: the means and
    residuals bit-equal to the CPU port's (IEEE division, round half to
    even, exact int32 sums and the scales added in shard order)."""
    from repro_torch.parallel import collectives as coll
    rng = np.random.default_rng(5)
    grads = [[(rng.standard_normal(65_536) * 10.0 ** rng.uniform(-3, 1))
              .astype(np.float32) for _ in range(2)] for _ in range(8)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        errs, means = None, []
        for g in grads:
            m, errs = coll.compressed_psum(
                [torch.from_numpy(x).to(dev) for x in g], errs)
            assert m[0].device.type == dev.type
            means.append(m[0].cpu())
        out[dev.type] = (means, [e.cpu() for e in errs])
    for a, b in zip(out["cuda"][0] + out["cuda"][1],
                    out["cpu"][0] + out["cpu"][1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
