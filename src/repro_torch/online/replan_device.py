"""Device-resident constrained suffix re-solve: the port of the
reference's ``online.replan_device`` (``Replanner._solve_group``'s
per-subset boundary optimization) on torch float64 tensors.

The host path loops ``shp._tier_subsets`` in Python, building per-subset
candidate grids and drift-conditioned term matrices in NumPy and running
``shp.solve_separable_terms``. This module evaluates the same suffix
objective — drift-conditioned write law W(b) = K·ln(1 + ρ(b − n0)/n0),
weighted survivor read mass, hop-priced relocation terms, pinned-boundary
relocation constants — and the same constraint structure (first/last-tier
capacity masks folded as +inf, middle-tier pairwise lower bounds, the
exact latency budget) as dense (R, C) tensors on one device, and reduces
each subset with the ``kernels.plan_solve`` solvers: ``ref.single_arr``
for two tiers, ``ref.tri_arr`` for three, and for four the
``plan_solve`` kernel itself (``ops.enum_solve``, one subset, S = 1,
zero constant) on a value-sorted grid. On a CUDA tensor that call
launches the kernel; on the CPU it runs the kernel's plain version.

Exactness follows the reference: the host's data-dependent ``np.any``
gates are computed once per call on the host, sums keep the host's order
and association, and first-minimum-wins tie-breaks survive as strict-<
folds (ties between equal-cost tuples may resolve to a different,
equal-cost boundary than the NumPy loop). Always float64: re-plan
decisions feed hysteresis and billing comparisons.

Under an active fleet mesh (``parallel.fleet``) the R flagged rows split
into the shards' contiguous blocks, each re-solved on its shard's device
(the four-tier subsets through ``plan_solve`` per shard), as the
reference's ``_solve_sharded_fn`` does; the outputs are bit-identical to
the unsharded re-solve. Not ported: the reference pads R (or each
shard's block) to a power of two, which only bounds XLA's compile cache
(one program per padded R); eager torch compiles nothing, so R runs as
it is.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import constraints as constraints_mod
from repro_torch.core import shp, shp_device
from repro_torch.kernels.plan_solve import ops as solve_ops
from repro_torch.kernels.plan_solve import ref as solve_ref
from repro_torch.parallel import fleet

_MOVE_TOL = 1e-6  # == replan._MOVE_TOL
_TOL = shp_device._TOL


def available(t: int) -> bool:
    return 2 <= t <= shp_device.MAX_DEVICE_TIERS


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _w_suffix(x, n0, rho, k):
    """``replan._w_suffix`` (drift-conditioned suffix write law)."""
    x = torch.maximum(x, n0)
    head = torch.clamp_min(torch.minimum(x, k) - n0, 0.0)
    start = torch.maximum(n0, k)
    u = start + rho * (torch.maximum(x, start) - start)
    return head + k * torch.log(u / start)


def _mass(x, anchor, rho, n):
    """``replan._mass`` (weighted survivor mass of [0, x))."""
    return torch.minimum(x, anchor) + rho * (_clip(x, anchor, n) - anchor)


def _reloc_cols(c, b0_j, n0, dens, price_up, price_dn, allow_moves):
    """``replan._reloc_terms`` on grid ``c`` (R, C). With ``allow_moves``
    False returns (None, blocked-mask) instead of the host's +inf fold so
    the caller can fold it once."""
    zero = torch.zeros_like(n0)
    delta = (_clip(c, zero[:, None], n0[:, None])
             - _clip(b0_j, zero, n0)[:, None])
    if not allow_moves:
        return None, torch.abs(delta) > _MOVE_TOL
    cost = dens[:, None] * torch.where(delta > 0, delta * price_up[:, None],
                                       -delta * price_dn[:, None])
    return cost, None


def _pinned_reloc(b0, n0, dens, cr, cw, sa, t, allow_moves):
    """``replan._pinned_reloc_const``."""
    zero = torch.zeros_like(n0)
    const = torch.zeros_like(n0)
    moves = torch.zeros_like(n0)
    for j in range(1, sa[0] + 1):
        cnt = dens * _clip(b0[:, j - 1], zero, n0)
        const = const + cnt * (cr[:, j - 1] + cw[:, j])
        moves = moves + cnt
    for j in range(sa[-1] + 1, t):
        cnt = dens * (n0 - _clip(b0[:, j - 1], zero, n0))
        const = const + cnt * (cr[:, j] + cw[:, j - 1])
        moves = moves + cnt
    if not allow_moves:
        const = torch.where(moves > _MOVE_TOL, torch.inf, 0.0).to(n0.dtype)
    return const


def _fold_cap_masks(f, c, j, ts, sa, sub_con, capfin, cap, kf, nf):
    """Fold the first/last-tier capacity masks into step ``j``'s terms as
    +inf on grid ``c`` — ``BoundaryObjective.terms``'s convention."""
    if sub_con and j == 1 and capfin[sa[0]]:
        ok = torch.minimum(c, kf[:, None]) <= cap[:, sa[0]][:, None] * _TOL
        f = torch.where(ok, f, torch.inf)
    if sub_con and j == ts - 1 and capfin[sa[-1]]:
        occ = torch.minimum(nf, kf)[:, None] * (1.0 - c / nf[:, None])
        ok = occ <= cap[:, sa[-1]][:, None] * _TOL
        f = torch.where(ok, f, torch.inf)
    return f


def _subset_candidate_cols(sa, cw_obj, lin, kf, nf, lo, hi, constrained,
                           capfin, slo_any, cap, lat, slo):
    """``BoundaryObjective.candidates``'s columns for the suffix objective
    (cw_s = ρ·cw, lin_s = drift-weighted read coefficients), under the
    host's any-finite gates — an unsorted column list."""
    ts = len(sa)
    cols = [lo, torch.minimum(kf, nf), hi]
    cols += shp_device.crossover_cols(cw_obj, lin, kf, lo, hi)
    if constrained:
        for j in sa:
            if not capfin[j]:
                continue
            cap_j = cap[:, j]
            fin = torch.isfinite(cap_j)
            cols.append(_clip(torch.where(fin, cap_j, 0.0), lo, hi))
            tight = nf * (1.0 - cap_j / kf)
            cols.append(_clip(torch.where(fin, tight, 0.0), lo, hi))
        if slo_any:
            for s, u in itertools.combinations(range(ts), 2):
                dl = lat[:, sa[s]] - lat[:, sa[u]]
                b = nf * (slo - lat[:, sa[u]]) / dl
                b = torch.where(torch.isfinite(b), b, 0.0)
                cols.append(_clip(b, lo, hi))
        for i in range(1, ts - 1):
            if capfin[sa[i]]:
                cols += shp_device.mid_cap_cols(
                    cw_obj[:, i - 1], cw_obj[:, i], cw_obj[:, i + 1],
                    lin[:, i - 1], lin[:, i], lin[:, i + 1],
                    cap[:, sa[i]], kf, lo, hi)
    return cols


def _solve_impl(cw, cr, cs, n, k, rpw, cap, lat, slo, n0, rho, b0, *, t,
                constrained, capfin, slo_any, allow_moves):
    """The suffix re-solve on (R, ·) float64 tensors of one device:
    (best total (R,), bounds (R, t-1), cost of the old bounds (R,))."""
    m = cw.shape[0]
    dtype, dev = cw.dtype, cw.device
    kf, nf = k, n
    s_n = n0 + rho * (n - n0)
    dens = torch.minimum(n0, k) / torch.clamp_min(n0, 1.0)
    start = torch.maximum(n0, k)
    w_n = _w_suffix(n, n0, rho, k)
    lo = torch.zeros_like(nf)
    best_val = torch.full((m,), torch.inf, dtype=dtype, device=dev)
    best_bounds = [torch.zeros((m,), dtype=dtype, device=dev)
                   for _ in range(t - 1)]
    for sa in shp._tier_subsets(t):
        ts = len(sa)
        sl = list(sa)
        lin = (rpw * k * rho / s_n)[:, None] * cr[:, sl]
        cw_obj = rho[:, None] * cw[:, sl]
        cap_s = cap[:, sl] if constrained else None
        lat_s = lat[:, sl] if constrained else None
        ok = shp_device.subset_feasible(m, ts, False, kf, nf, cap_s, lat_s,
                                        slo)
        reloc_const = _pinned_reloc(b0, n0, dens, cr, cw, sa, t,
                                    allow_moves)
        const = (w_n * cw[:, sa[-1]] + rpw * k * cr[:, sa[-1]]
                 + reloc_const + k * cs[:, sl].amax(dim=1))
        if ts == 1:
            total = torch.where(ok, const, torch.inf)
            bounds_cols = [nf if j >= sa[0] else torch.zeros_like(nf)
                           for j in range(t - 1)]
        else:
            cols = _subset_candidate_cols(sa, cw_obj, lin, kf, nf, lo, nf,
                                          constrained, capfin, slo_any,
                                          cap, lat, slo)
            ustars = shp_device.crossover_cols(
                cw[:, sl], lin, rho * k, lo, torch.full_like(nf, torch.inf))
            cols.append(_clip(n0, lo, nf))
            cols += [_clip(start + (u - start) / rho, lo, nf)
                     for u in ustars]
            cols += [_clip(b0[:, j], lo, nf) for j in range(t - 1)]
            c = torch.stack(cols, dim=1)
            sub_con = (constrained
                       and (any(capfin[j] for j in sa) or slo_any))

            def build_fs(grid):
                """The drift-conditioned per-step suffix terms on one
                candidate grid: write law + survivor mass + hop-priced
                relocation columns, capacity masks folded as +inf."""
                out = []
                for s in range(1, ts):
                    u, v = sa[s - 1], sa[s]
                    f = ((cw[:, u] - cw[:, v])[:, None]
                         * _w_suffix(grid, n0[:, None], rho[:, None],
                                     k[:, None])
                         + ((cr[:, u] - cr[:, v]) * rpw * k / s_n)[:, None]
                         * _mass(grid, n0[:, None], rho[:, None],
                                 n[:, None]))
                    blocked = None
                    for j in range(u + 1, v + 1):
                        cost, blk = _reloc_cols(
                            grid, b0[:, j - 1], n0, dens,
                            cr[:, j] + cw[:, j - 1],
                            cr[:, j - 1] + cw[:, j], allow_moves)
                        if cost is not None:
                            f = f + cost
                        if blk is not None:
                            blocked = blk if blocked is None else \
                                blocked | blk
                    f = _fold_cap_masks(f, grid, s, ts, sa, sub_con, capfin,
                                        cap, kf, nf)
                    if blocked is not None:
                        f = torch.where(blocked, torch.inf, f)
                    out.append(f)
                return out

            fs = build_fs(c)
            kw = {}
            if sub_con and slo_any:
                cmax = c.amax(dim=1)
                alphas, scale = [], None
                for j in range(1, ts):
                    al = (lat[:, sa[j - 1]] - lat[:, sa[j]]) / nf
                    alphas.append(al)
                    sc = torch.abs(cmax * al)
                    scale = sc if scale is None else scale + sc
                rhs = slo - lat[:, sa[-1]]
                kw = dict(alpha=alphas, rhs=rhs,
                          atol=1e-9 * (torch.abs(rhs) + scale) + 1e-15)
            if ts == 2:
                interior, bvec = solve_ref.single_arr(fs[0], c, **kw)
            elif ts == 3:
                if sub_con and capfin[sa[1]]:
                    kw.update(kf=kf, cap_m=cap[:, sa[1]])
                interior, bvec = solve_ref.tri_arr(fs[0], fs[1], c, **kw)
            else:  # ts == 4: the plan_solve kernel on a sorted grid
                c_s = torch.sort(c, dim=1).values
                fs4 = torch.stack(build_fs(c_s), dim=1)[:, None]
                kw4 = {}
                if sub_con and any(capfin[sa[i]] for i in range(1, ts - 1)):
                    kw4["pair_caps"] = [
                        cap[:, sa[j]][:, None] if capfin[sa[j]] else None
                        for j in range(1, ts - 1)]
                    kw4["kf"] = kf
                if kw:
                    kw4.update(alpha=torch.stack(kw["alpha"], 1)[:, None],
                               rhs=kw["rhs"][:, None],
                               atol=kw["atol"][:, None])
                interior, _, selm = solve_ops.enum_solve(
                    fs4, (torch.zeros((m, 1), dtype=dtype, device=dev),),
                    cand=c_s[:, None].contiguous(), **kw4)
                bvec = [solve_ref.pick_col(c_s, selm[:, j])
                        for j in range(ts - 1)]
            total = torch.where(ok, interior + const, torch.inf)
            bounds_cols = shp_device._subset_bounds_cols(sa, t, bvec, nf)
        upd = total < best_val
        best_val = torch.where(upd, total, best_val)
        best_bounds = [torch.where(upd, bc, bb)
                       for bc, bb in zip(bounds_cols, best_bounds)]
    # ``replan.suffix_cost`` at the old boundaries — the like-for-like
    # comparison side of the hysteresis decision
    edges = [torch.zeros_like(nf)] + [b0[:, j] for j in range(t - 1)] + [nf]
    writes = torch.zeros_like(nf)
    reads = torch.zeros_like(nf)
    storage = torch.full_like(nf, -torch.inf)
    for j in range(t):
        wj = (_w_suffix(edges[j + 1], n0, rho, k)
              - _w_suffix(edges[j], n0, rho, k))
        writes = writes + wj * cw[:, j]
        mj = (_mass(edges[j + 1], n0, rho, n)
              - _mass(edges[j], n0, rho, n))
        reads = reads + mj * cr[:, j]
        used = edges[j + 1] - edges[j] > 0
        storage = torch.maximum(storage,
                                torch.where(used, cs[:, j], -torch.inf))
    cost_old = writes + reads * (rpw * k / s_n) + k * storage
    return best_val, torch.stack(best_bounds, dim=1), cost_old


def solve_group(cw, cr, cs, n, k, rpw, cap, lat, slo, n0, rho, b0, *,
                allow_moves=True, device=None):
    """Device re-solve of one uniform-tier-count drift-flagged group.
    Inputs mirror ``Replanner._solve_group``'s stacked numpy arrays;
    ``device`` is where it runs (the CUDA card unless given; under an
    active fleet mesh, the shards' devices). Returns numpy (total (R,),
    bounds (R, t-1), cost_old (R,)) with +inf totals where no feasible
    plan exists."""
    r, t = np.shape(cw)
    if not available(t):
        raise ValueError(f"device suffix re-solve covers 2 <= t <= "
                         f"{shp_device.MAX_DEVICE_TIERS}, got t={t}")
    mesh = fleet.get_fleet_mesh()
    if mesh is None:
        blocks = [(0, r, device_mod.resolve(device))]
    else:
        blocks = [(lo, hi, d) for (lo, hi), d in zip(
            fleet.row_blocks(r, fleet.n_shards(mesh)), mesh.devices)
            if hi > lo] or [(0, r, mesh.devices[0])]
    cap_h = np.asarray(cap, np.float64)
    slo_h = np.asarray(slo, np.float64)
    # the data gates stay R-wide, so each shard solves the unsharded
    # run's grids
    constrained = not constraints_mod.trivial(cap_h, slo_h)
    capfin = tuple(bool(np.any(np.isfinite(cap_h[:, j]))) for j in range(t))
    slo_any = bool(np.any(np.isfinite(slo_h)))
    host = [np.asarray(x, np.float64)
            for x in (cw, cr, cs, n, k, rpw, cap, lat, slo, n0, rho, b0)]
    outs = []
    for lo, hi, dev in blocks:
        args = [torch.as_tensor(x[lo:hi], device=dev) for x in host]
        out = _solve_impl(*args, t=t, constrained=constrained,
                          capfin=capfin, slo_any=slo_any,
                          allow_moves=bool(allow_moves))
        outs.append([o.cpu().numpy() for o in out])
    if len(outs) == 1:
        return tuple(outs[0])
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(3))
