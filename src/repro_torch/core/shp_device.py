"""Device-resident batched N-tier planner: the port of the reference's
``core.shp_jax`` on torch tensors, with the joint constrained reduction
in the hand-written ``plan_solve`` kernel.

``shp.plan_ntier_arrays_numpy`` minimizes the separable boundary
objective per tier subset with host-side NumPy: a Python loop over the
subsets, per-subset candidate grids, and an ``itertools`` enumeration for
the constrained joint solve. This module builds the same finite candidate
structure as dense per-subset tensors on the device and reduces every
(family, subset size) group of subsets with ``kernels.plan_solve``, as
the reference's TPU route (``_pallas_group``) does:

* ``capfin`` (per-tier any-finite-capacity) and ``slo_any`` are computed
  on the host and replicate the ``np.any`` gates of
  ``BoundaryObjective.candidates`` / ``pair_lower_bound`` /
  ``budget_deltas``, so each subset's grid has exactly the host's
  columns;
* candidate columns are pooled per family: a crossover, capacity corner
  or SLO-tight point depends only on the global tier pair, so W(b) — the
  log — is evaluated once per distinct column, and each subset's grid is
  a stable sort of its pool columns with W gathered by the same
  permutation (W is a function of the value, so the grid is the one the
  reference's sorting network gives);
* the subsets of one group stack on an S axis, their grids padded at the
  front by duplicating the lowest column (value, term and mask), and the
  kernel keeps the host's first-minimum precedence (strict ``<`` running
  minima in subset order: no-migration subsets ascending by size, then
  cascades).

Precision: constrained solves default to float64 (oracle-matching to
~1e-11 relative on totals), unconstrained ones to float32 (plans optimal
to ~1e-8 relative, totals to float32 accuracy): the reference's
defaults off the TPU. The H100 has native float64, so the kernel runs in
both.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.kernels.plan_solve import ops as solve_ops
from repro_torch.parallel import fleet

from . import constraints as constraints_mod

MAX_DEVICE_TIERS = 4  # the exact joint enumeration (shp._ENUM_MAX_STEPS + 1)
_TOL = 1.0 + 1e-12
DEFAULT_PRECISION_UNCONSTRAINED = "float32"
DEFAULT_PRECISION_CONSTRAINED = "float64"
_CHUNK_BYTES = 8 << 30  # device memory one chunk of streams may take
_BIG_I = 2 ** 30


class DeviceSolverUnavailable(RuntimeError):
    """Raised when the device solver cannot take this problem (a hierarchy
    deeper than the exact enumeration supports)."""


@functools.lru_cache(maxsize=None)
def _groups(t: int):
    """Subset groups in the host solver's precedence order. Each entry is
    (interior, ts, subsets): the no-migration subsets ascending by size,
    then the migration cascades (all ending at tier t-1)."""
    nm = tuple((False, ts, tuple(itertools.combinations(range(t), ts)))
               for ts in range(1, t + 1))
    mg = tuple((True, size + 1,
                tuple(s + (t - 1,)
                      for s in itertools.combinations(range(t - 1), size)))
               for size in range(1, t))
    return nm + mg


@functools.lru_cache(maxsize=None)
def _mid_triples(t: int):
    """Distinct (prev, mid, next) consecutive-tier triples across the
    no-migration subsets — the middle-capacity stationary columns are the
    only candidate columns owned by a triple rather than a pair."""
    seen, out = set(), []
    for interior, ts, subs in _groups(t):
        if interior or ts < 3:
            continue
        for sa in subs:
            for i in range(1, ts - 1):
                tri = (sa[i - 1], sa[i], sa[i + 1])
                if tri not in seen:
                    seen.add(tri)
                    out.append(tri)
    return tuple(out)


# ---------------------------------------------------------------------------
# Mirrors of BoundaryObjective's candidate/term/feasibility laws
# ---------------------------------------------------------------------------

def w_approx(b, k):
    """``shp._w_approx`` on tensors: W(b) = b below K, K(1 + ln(b/K))
    above."""
    safe = torch.clamp_min(b, torch.finfo(b.dtype).tiny)
    return torch.where(b <= k, b, k * (1.0 + torch.log(safe / k)))


def crossover_cols(cw_s, lin_s, kf, lo, hi):
    """``shp._crossover_candidates``: the eq. 17/21-style pairwise
    stationary points, one column per tier pair, clipped into [lo, hi]."""
    out = []
    for s, t in itertools.combinations(range(cw_s.shape[1]), 2):
        b = kf * (cw_s[:, s] - cw_s[:, t]) / (lin_s[:, t] - lin_s[:, s])
        b = torch.where(torch.isfinite(b), b, 0.0)
        out.append(torch.clamp(b, lo, hi))
    return out


def mid_cap_cols(cw_p, cw_m, cw_n, lin_p, lin_m, lin_n, cap_m, kf, lo, hi):
    """``BoundaryObjective._middle_cap_stationary`` for one (prev, mid,
    next) tier triple: 4 columns (log/mixed branch × the γ-image),
    sanitized to ``lo`` where the capacity curve is inactive."""
    active = torch.isfinite(cap_m) & (cap_m < kf)
    gamma = 1.0 - cap_m / kf
    dcw_p, dcw_d = cw_p - cw_m, cw_m - cw_n
    dlin_p, dlin_d = lin_p - lin_m, lin_m - lin_n
    b_log = -kf * (dcw_p + dcw_d) / (gamma * dlin_p + dlin_d)
    b_mix = -kf * dcw_d / (gamma * (dcw_p + dlin_p) + dlin_d)
    out = []
    for b in (b_log, b_mix):
        b = torch.where(active & torch.isfinite(b) & (b > 0), b, 0.0)
        out.append(torch.clamp(b, lo, hi))
        out.append(torch.clamp(b * torch.where(active, gamma, 0.0), lo, hi))
    return out


def subset_feasible(m, ts, interior, kf, nf, cap_s, lat_s, slo):
    """``BoundaryObjective.subset_feasible``."""
    if cap_s is None:
        return torch.ones((m,), dtype=torch.bool, device=kf.device)
    kmin = torch.minimum(kf, nf)
    if ts == 1:
        return (kmin <= cap_s[:, 0] * _TOL) & (lat_s[:, 0] <= slo * _TOL)
    if interior:
        return ((cap_s * _TOL >= kmin[:, None]).all(dim=1)
                & (lat_s[:, -1] <= slo * _TOL))
    return torch.ones((m,), dtype=torch.bool, device=kf.device)


# ---------------------------------------------------------------------------
# Per-family candidate pools
# ---------------------------------------------------------------------------

def _build_pool(t, interior, constrained, capfin, slo_any, cw, lin, cap,
                lat, slo, kf, nf, lo, hi):
    """One family's pooled candidate columns and their W values: every
    candidate column the host generates per subset is owned by a global
    tier pair, tier or triple, so each distinct column — and the log in W
    — is computed once. Returns (columns, W columns, {key: index})."""
    cols, key_idx = [], {}

    def add(key, col):
        key_idx[key] = len(cols)
        cols.append(col)

    add(("b", 0), lo)
    add(("b", 1), torch.minimum(kf, nf))
    add(("b", 2), hi)
    for (u, v), col in zip(itertools.combinations(range(t), 2),
                           crossover_cols(cw, lin, kf, lo, hi)):
        add(("x", u, v), col)
    if constrained:
        for j in range(t):
            if not capfin[j]:
                continue
            cap_j = cap[:, j]
            fin = torch.isfinite(cap_j)
            add(("cap", j, 0),
                torch.clamp(torch.where(fin, cap_j, 0.0), lo, hi))
            tight = nf * (1.0 - cap_j / kf)
            add(("cap", j, 1),
                torch.clamp(torch.where(fin, tight, 0.0), lo, hi))
        if not interior and slo_any:
            for u, v in itertools.combinations(range(t), 2):
                dl = lat[:, u] - lat[:, v]
                b = nf * (slo - lat[:, v]) / dl
                b = torch.where(torch.isfinite(b), b, 0.0)
                add(("slo", u, v), torch.clamp(b, lo, hi))
        if not interior:
            for (p, md, nx) in _mid_triples(t):
                if not capfin[md]:
                    continue
                mids = mid_cap_cols(cw[:, p], cw[:, md], cw[:, nx],
                                    lin[:, p], lin[:, md], lin[:, nx],
                                    cap[:, md], kf, lo, hi)
                for q, col in enumerate(mids):
                    add(("mid", p, md, nx, q), col)
    return cols, [w_approx(col, kf) for col in cols], key_idx


def _subset_keys(sa, interior, constrained, capfin, slo_any):
    """The pool columns of one subset's candidate grid — the same columns,
    under the same any-finite gates, the host appends in
    ``BoundaryObjective.candidates``."""
    ts = len(sa)
    keys = [("b", 0), ("b", 1), ("b", 2)]
    keys += [("x", sa[s], sa[t])
             for s, t in itertools.combinations(range(ts), 2)]
    if constrained:
        for j in sa:
            if capfin[j]:
                keys += [("cap", j, 0), ("cap", j, 1)]
        if not interior and slo_any:
            keys += [("slo", sa[s], sa[t])
                     for s, t in itertools.combinations(range(ts), 2)]
        if not interior:
            for i in range(1, ts - 1):
                if capfin[sa[i]]:
                    keys += [("mid", sa[i - 1], sa[i], sa[i + 1], q)
                             for q in range(4)]
    return keys


# ---------------------------------------------------------------------------
# Group assembly and reduction
# ---------------------------------------------------------------------------

def _subset_grid(sa, interior, pool, w_pool, key_idx, constrained, capfin,
                 slo_any, cw, lin, cap, lat, slo, kf, nf):
    """One subset's sorted candidate grid (M, C), its per-step term grids
    and (M, C) bool masks (None = no mask on that step), the pairwise
    lower-bound pattern and, when the latency budget is active, its
    coefficients."""
    ts = len(sa)
    idxs = [key_idx[key]
            for key in _subset_keys(sa, interior, constrained, capfin,
                                    slo_any)]
    c, perm = torch.sort(torch.stack([pool[i] for i in idxs], dim=1), dim=1,
                         stable=True)
    w = torch.gather(torch.stack([w_pool[i] for i in idxs], dim=1), 1, perm)
    sub_con = (constrained and not interior
               and (any(capfin[j] for j in sa) or slo_any))
    lb_pattern = tuple(constrained and not interior and capfin[sa[i]]
                       for i in range(1, ts - 1))
    budget = sub_con and slo_any
    fs, masks = [], []
    for j in range(1, ts):
        u, v = sa[j - 1], sa[j]
        f = ((cw[:, u] - cw[:, v])[:, None] * w
             + (lin[:, u] - lin[:, v])[:, None] * c)
        mk = None
        if sub_con and j == 1 and capfin[sa[0]]:
            mk = torch.minimum(c, kf[:, None]) <= cap[:, sa[0]][:, None] * _TOL
        if sub_con and j == ts - 1 and capfin[sa[-1]]:
            occ = torch.minimum(nf, kf)[:, None] * (1.0 - c / nf[:, None])
            l_ok = occ <= cap[:, sa[-1]][:, None] * _TOL
            mk = l_ok if mk is None else mk & l_ok
        fs.append(f)
        masks.append(mk)
    out = {"sa": sa, "cand": c, "fs": fs, "masks": masks,
           "lb_pattern": lb_pattern}
    if budget:
        cmax = c.amax(dim=1)
        alphas, scale = [], None
        for j in range(1, ts):
            al = (lat[:, sa[j - 1]] - lat[:, sa[j]]) / nf
            alphas.append(al)
            sc = torch.abs(cmax * al)
            scale = sc if scale is None else scale + sc
        rhs = slo - lat[:, sa[-1]]
        out.update(alpha=alphas, rhs=rhs,
                   atol=1e-9 * (torch.abs(rhs) + scale) + 1e-15)
    return out


def _subset_bounds_cols(sa, t, bvec_cols, nf):
    """Full-topology boundary columns from one subset's chosen boundary
    values — the host's edges → widths → cumsum, as column sums."""
    zero = torch.zeros_like(nf)
    edges = [zero] + list(bvec_cols) + [nf]
    widths = [edges[j + 1] - edges[j] for j in range(len(sa))]
    wfull = [zero] * t
    for j, tier in enumerate(sa):
        wfull[tier] = wfull[tier] + widths[j]
    acc, cum = zero, []
    for tier in range(t - 1):
        acc = acc + wfull[tier]
        cum.append(acc)
    return cum


def decode_bounds(s_idx, sel, cand_stack, subs, nf, t):
    """Winning (subset row, candidate tuple) -> (M, t-1) full-topology
    boundary vectors: select the winner's grid, gather its boundary
    values, and rebuild each subset's boundary columns, keeping the
    winner's."""
    cand_sel = cand_stack[:, 0]
    for i in range(1, len(subs)):
        cand_sel = torch.where((s_idx == i)[:, None], cand_stack[:, i],
                               cand_sel)
    bvec = torch.gather(cand_sel, 1, sel.long())  # (M, J)
    bounds = None
    for i, sa in enumerate(subs):
        bi = torch.stack(_subset_bounds_cols(
            sa, t, [bvec[:, j] for j in range(bvec.shape[1])], nf), dim=1)
        bounds = bi if bounds is None else torch.where(
            (s_idx == i)[:, None], bi, bounds)
    return bounds


def _pad_front(x, npad):
    """Duplicate the lowest column ``npad`` times in front: keeps a grid
    sorted and adds no tuple the unpadded grid lacked."""
    return torch.cat([x[:, :1].expand(-1, npad), x], dim=1) if npad else x


def _group_solve(subs, ts, interior, pool, w_pool, key_idx, constrained,
                 capfin, slo_any, cw, lin, cap, lat, slo, kf, nf, t,
                 subset_consts):
    """One (family, size) group's subsets stacked on an S axis and reduced
    by ``plan_solve`` in one launch. Returns (val (M,), bounds (M, t-1))."""
    m = kf.shape[0]
    entries = []
    for sa in subs:
        sub = _subset_grid(sa, interior, pool, w_pool, key_idx, constrained,
                           capfin, slo_any, cw, lin, cap, lat, slo, kf, nf)
        sub["consts"] = subset_consts(sa, interior, lin)
        entries.append(sub)
    cmax = max(e["cand"].shape[1] for e in entries)
    for e in entries:
        npad = cmax - e["cand"].shape[1]
        e["cand"] = _pad_front(e["cand"], npad)
        e["fs"] = [_pad_front(f, npad) for f in e["fs"]]
        e["masks"] = [None if mk is None else _pad_front(mk, npad)
                      for mk in e["masks"]]
    fs = torch.stack([torch.stack(e["fs"], 1) for e in entries], 1)
    cand = torch.stack([e["cand"] for e in entries], 1)
    consts = tuple(torch.stack([e["consts"][p] for e in entries], 1)
                   for p in range(3))
    kw = {}
    if constrained and not interior:
        if ts > 2 and any(any(e["lb_pattern"]) for e in entries):
            kw["pair_caps"] = [
                torch.stack([cap[:, e["sa"][j]] if e["lb_pattern"][j - 1]
                             else torch.full_like(kf, torch.inf)
                             for e in entries], 1)
                for j in range(1, ts - 1)]
            kw["kf"] = kf
        if slo_any:
            kw["alpha"] = torch.stack(
                [torch.stack(e["alpha"], 1) for e in entries], 1)
            kw["rhs"] = torch.stack([e["rhs"] for e in entries], 1)
            kw["atol"] = torch.stack([e["atol"] for e in entries], 1)
        ones = torch.ones((m, cmax), dtype=torch.bool, device=kf.device)
        kw["masks"] = [
            torch.stack([ones if e["masks"][j] is None else e["masks"][j]
                         for e in entries], 1)
            for j in range(ts - 1)]
    val, s_idx, sel = solve_ops.enum_solve(fs, consts, cand=cand, **kw)
    return val, decode_bounds(s_idx, sel, cand, [e["sa"] for e in entries],
                              nf, t)


def _plan(cw, cr, cs, n, k, rpw, cap, lat, slo, *, t, constrained, capfin,
          slo_any):
    """The whole solve on one chunk of streams (tensors on one device, one
    float type). Returns (total (M,), bounds (M, t-1), migrate (M,))."""
    m = cw.shape[0]
    kf, nf = k, n
    w_n = w_approx(n, k)
    lin_nm = (rpw * k / n)[:, None] * cr
    lin_mg = (k / n)[:, None] * cs
    pools = {}
    for interior in (False, True):
        lin = lin_mg if interior else lin_nm
        lo = torch.minimum(kf, nf) if interior else torch.zeros_like(nf)
        hi = torch.nextafter(nf, torch.zeros_like(nf)) if interior else nf
        pools[interior] = _build_pool(
            t, interior, constrained, capfin, slo_any, cw, lin, cap, lat,
            slo, kf, nf, lo, hi) + (lin,)

    def subset_consts(sa, interior, lin):
        ts = len(sa)
        sl = list(sa)
        cap_s = cap[:, sl] if constrained else None
        lat_s = lat[:, sl] if constrained else None
        ok = subset_feasible(m, ts, interior, kf, nf, cap_s, lat_s, slo)
        a = w_n * (cw[:, -1] if interior else cw[:, sa[-1]])
        b = nf * lin[:, -1] if interior else nf * lin[:, sa[-1]]
        if interior:
            fee = torch.zeros_like(nf)
            for u, v in zip(sa, sa[1:]):
                fee = fee + cr[:, u] + cw[:, v]
            cc = kf * fee
        else:
            cc = kf * cs[:, sl].amax(dim=1)
        return torch.where(ok, a, torch.inf), b, cc

    # every subset (ts = 1) or group (ts >= 2) contributes (total, bounds,
    # migration flag) in the host's subset order; the cross-subset winner
    # is one first-minimum argmin at the end, which keeps the host loop's
    # strict-< precedence
    totals, bounds, migs = [], [], []
    for interior, ts, subs in _groups(t):
        pool, w_pool, key_idx, lin = pools[interior]
        if ts == 1:
            for sa in subs:
                a, b, cc = subset_consts(sa, interior, lin)
                totals.append(((a + b) + cc))
                bounds.append(torch.stack(
                    [nf if j >= sa[0] else torch.zeros_like(nf)
                     for j in range(t - 1)], dim=1))
                migs.append(interior)
            continue
        val, bnd = _group_solve(subs, ts, interior, pool, w_pool, key_idx,
                                constrained, capfin, slo_any, cw, lin, cap,
                                lat, slo, kf, nf, t, subset_consts)
        totals.append(val)
        bounds.append(bnd)
        migs.append(interior)
    tots = torch.stack(totals, dim=1)
    best_val = tots.amin(dim=1)
    iota = torch.arange(tots.shape[1], dtype=torch.int32, device=tots.device)
    hit = torch.where(tots == best_val[:, None], iota, _BIG_I).amin(dim=1)
    s_idx = torch.where(hit == _BIG_I, 0, hit)  # NaN rows: the first entry
    best_bounds = bounds[0]
    for i in range(1, len(bounds)):
        best_bounds = torch.where((s_idx == i)[:, None], bounds[i],
                                  best_bounds)
    # no-migration entries all precede the cascades, so the migrate flag
    # is one index compare
    first_mig = migs.index(True) if True in migs else len(migs)
    best_mig = (s_idx >= first_mig) & torch.isfinite(best_val)
    return best_val, best_bounds, best_mig


def _chunk_rows(t, constrained, capfin, slo_any, itemsize):
    """Streams per chunk: as many as keep one chunk's grids (about 32
    (M, S, J, C) tensors of the largest group, and the pools) within
    ``_CHUNK_BYTES``."""
    sjc = max(len(subs) * (ts - 1) * max(
        len(_subset_keys(sa, interior, constrained, capfin, slo_any))
        for sa in subs)
        for interior, ts, subs in _groups(t) if ts > 1)
    return max(1, _CHUNK_BYTES // (32 * sjc * itemsize + 4096))


def plan_ntier_arrays_device(cw, cr, cs, n, k, rpw, *, cap=None, lat=None,
                             slo=None, force_constrained=False,
                             precision=None, device=None):
    """Device-resident ``shp.plan_ntier_arrays``: same contract, same
    returns (NumPy float64 ``total`` (M,), ``bounds`` (M, T-1), bool
    ``migrate`` (M,); infeasible streams get ``total = +inf`` and zeroed
    bounds), solved on ``device`` — the CUDA card unless the caller names
    another.

    ``precision``: "float64" (default for constrained solves,
    oracle-matching to ~1e-11 relative) or "float32" (default for
    unconstrained ones). Raises ``DeviceSolverUnavailable`` for
    hierarchies the exact joint enumeration does not cover (T > 4).

    Under an active fleet mesh (``parallel.fleet.use_fleet_mesh``) the
    rows split into the shards' contiguous blocks, each solved on its
    shard's device (``device`` is then not used), and the outputs are
    concatenated: bit-identical to the unsharded solve. The reference
    pads each shard's block to a power of two, which only bounds XLA's
    compile cache; eager torch has none, so the blocks run as they are."""
    mesh = fleet.get_fleet_mesh()
    dev = device_mod.resolve(device) if mesh is None else None
    cw = np.asarray(cw, np.float64)
    m, t = cw.shape
    if not 2 <= t <= MAX_DEVICE_TIERS:
        raise DeviceSolverUnavailable(
            f"device solver covers 2..{MAX_DEVICE_TIERS} tiers, got {t}")
    if m == 0:
        return {"total": np.zeros(0), "bounds": np.zeros((0, t - 1)),
                "migrate": np.zeros(0, bool)}
    constrained = bool(force_constrained
                       or not constraints_mod.trivial(cap, slo))
    cap_h = (np.full((m, t), np.inf) if cap is None
             else np.asarray(cap, np.float64))
    lat_h = np.zeros((m, t)) if lat is None else np.asarray(lat, np.float64)
    slo_h = (np.full(m, np.inf) if slo is None
             else np.asarray(slo, np.float64))
    # the host's np.any data gates, fixed before the solve
    capfin = tuple(bool(np.any(np.isfinite(cap_h[:, j]))) for j in range(t))
    slo_any = bool(np.any(np.isfinite(slo_h)))
    if precision is None:
        precision = (DEFAULT_PRECISION_CONSTRAINED if constrained
                     else DEFAULT_PRECISION_UNCONSTRAINED)
    if precision not in ("float32", "float64"):
        raise ValueError(f"unknown precision {precision!r}")
    np_dtype = np.float64 if precision == "float64" else np.float32
    # rounded to the solve's type on the host, as the reference does
    args = [np.asarray(x, np_dtype).reshape(m, t) for x in (cw, cr, cs)]
    args += [np.asarray(x, np_dtype).reshape(m) for x in (n, k, rpw)]
    args += [a.astype(np_dtype) for a in (cap_h.reshape(m, t),
                                          lat_h.reshape(m, t),
                                          slo_h.reshape(m))]
    chunk = _chunk_rows(t, constrained, capfin, slo_any,
                        np.dtype(np_dtype).itemsize)
    # an active fleet mesh solves each shard's rows on its own device
    # (the reference's ``shp_jax._plan_sharded``); the gates above stay
    # fleet-wide, so every shard builds the unsharded run's grids
    if mesh is None:
        blocks = [(0, m, dev)]
    else:
        blocks = [(lo, hi, d) for (lo, hi), d in zip(
            fleet.row_blocks(m, fleet.n_shards(mesh)), mesh.devices)]
    outs = []
    for b_lo, b_hi, b_dev in blocks:
        for lo in range(b_lo, b_hi, chunk):
            hi = min(lo + chunk, b_hi)
            part = [torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
                    .to(b_dev) for a in args]
            out = _plan(*part, t=t, constrained=constrained,
                        capfin=capfin, slo_any=slo_any)
            outs.append([o.cpu().numpy() for o in out])
    total, bounds, mig = (np.concatenate([o[i] for o in outs])
                          for i in range(3))
    total = total.astype(np.float64)
    feas = np.isfinite(total)
    return {"total": total,
            "bounds": np.where(feas[:, None], bounds.astype(np.float64), 0.0),
            "migrate": mig & feas}
