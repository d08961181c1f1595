"""Plain-torch reductions over one tier subset's candidate grid (M, C):
the counterparts of the reference's ``kernels.plan_solve.ref`` solvers
that its device suffix re-solve (``online.replan_device``) runs outside
any Pallas kernel. They are elementwise code and reductions, not TPU
kernels, so plain PyTorch is what runs them on either device.

* ``dp_arr`` — the monotone running-minimum DP
  (``core.shp._solve_unconstrained``): exact when no pairwise lower
  bound or latency budget couples the boundaries.
* ``tri_arr`` — the exact joint J=2 enumeration as a loop over the
  destination candidate, each step a masked minimum over the origins.
* ``single_arr`` — the J=1 case.

Each mirrors the reference's arithmetic and tie-breaks bit for bit:
per-step values summed in step order, masks folded as +inf by the
caller, the first minimum wins. ``value_argmin`` takes the smallest
candidate *value* among the minimal-cost columns of an unsorted grid
(the host's first index on its value-sorted grid), not
``torch.argmin``'s first index. ``tri_arr`` recovers the winning origin
by the equality ``f0 == bm0``, which holds because ``f0`` is computed
once and read by both passes: keep this path eager (no
``torch.compile``), so no compiler recomputes ``f0`` in another
rounding.
"""
from __future__ import annotations

import torch

from .ops import pair_lb_law

_BIG_I = 2 ** 30


def first_argmin(x, dim: int = -1):
    """(min, first index attaining it) as a min and a masked-index min,
    the first minimum winning. NaN rows return index 0 with the NaN
    minimum, which the callers' strict-< folds then discard."""
    vmin = x.amin(dim=dim)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    iota = torch.arange(x.shape[dim], dtype=torch.int32,
                        device=x.device).reshape(shape)
    hit = torch.where(x == vmin.unsqueeze(dim), iota, _BIG_I)
    amin = hit.amin(dim=dim)
    return vmin, torch.where(amin == _BIG_I, 0, amin)


def pick_col(x, idx):
    """x[:, idx] per row as a one-hot sum (the reference's form: a -0.0
    pick comes back +0.0). ``x`` (M, C), ``idx`` (M,) int."""
    onehot = idx[:, None] == torch.arange(x.shape[1], dtype=idx.dtype,
                                          device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(onehot, x, zero).sum(dim=1).to(x.dtype)


def _cummin_with_arg(g):
    """Running minima over the columns of (M, C) and the column where each
    was first attained (strict-< update, first minimum wins)."""
    best = g[:, 0]
    barg = torch.zeros(best.shape, dtype=torch.int32, device=g.device)
    vals, args = [best], [barg]
    for j in range(1, g.shape[1]):
        col = g[:, j]
        upd = col < best
        best = torch.where(upd, col, best)
        barg = torch.where(upd, j, barg)
        vals.append(best)
        args.append(barg)
    return torch.stack(vals, dim=1), torch.stack(args, dim=1)


def dp_arr(fs):
    """Monotone DP over per-step term grids ``fs`` (list of J (M, C)):
    g_j = f_j + cummin(g_{j-1}). Returns (interior (M,), sel list of J
    (M,) int32 candidate indices)."""
    g = fs[0]
    args = []
    for j in range(1, len(fs)):
        vals, arg = _cummin_with_arg(g)
        args.append(arg)
        g = fs[j] + vals
    interior, best_c = first_argmin(g)
    sel_rev = [best_c]
    for arg in reversed(args):
        best_c = pick_col(arg, best_c)
        sel_rev.append(best_c)
    return interior, list(reversed(sel_rev))


def value_argmin(f, cand):
    """(min of f, boundary value attaining it) over an *unsorted* grid:
    among minimal-cost candidates the smallest boundary value wins — the
    host's first-index tie-break on its value-sorted grid. All-inf (or
    NaN-poisoned) rows return +inf values, which the callers' strict-<
    folds discard."""
    vmin = f.amin(dim=1)
    bval = torch.where(f == vmin[:, None], cand, torch.inf).amin(dim=1)
    return vmin, bval


def single_arr(f0, cand, *, alpha=None, rhs=None, atol=None):
    """Exact J=1 reduction: masked minimum over the (unsorted) candidate
    grid (the budget, when active, is the per-candidate value test
    δ_0 = α_0·value <= rhs + atol). Returns (interior (M,), [bval])."""
    if alpha is not None:
        ok = cand * alpha[0][:, None] <= (rhs + atol)[:, None]
        f0 = torch.where(ok, f0, torch.inf)
    interior, bval = value_argmin(f0, cand)
    return interior, [bval]


def tri_arr(f0, f1, cand, *, kf=None, cap_m=None, alpha=None, rhs=None,
            atol=None):
    """Exact J=2 enumeration as a destination loop over (M, C) grids —
    *unsorted* grids welcome: monotonicity (origin value <= destination
    value) is a mask, so the value pairs enumerated are the host's
    index-monotone tuples over the sorted grid. Origins are further
    filtered by the lower-bound law (middle-tier capacity ``cap_m``) and
    the latency budget (δ_j = α_j·value, Σδ <= rhs + atol). The winner's
    interior is f0 + f1. Returns (interior (M,), [bv0, bv1])."""
    budget_cap = (rhs + atol) if alpha is not None else None
    best = torch.full(f0.shape[:1], torch.inf, dtype=f0.dtype,
                      device=f0.device)
    bm0 = torch.full_like(best, torch.inf)
    bv1 = torch.zeros_like(best)

    def feasible(dest):
        feas = cand <= dest[:, None]
        if cap_m is not None:
            lbd = pair_lb_law(dest, cap_m, kf) * (1 - 1e-12) - 1e-12
            feas = feas & (cand >= lbd[:, None])
        if alpha is not None:
            acc = cand * alpha[0][:, None] + (dest * alpha[1])[:, None]
            feas = feas & (acc <= budget_cap[:, None])
        return feas

    for c1 in range(cand.shape[1]):
        c1v = cand[:, c1]
        m0 = torch.where(feasible(c1v), f0, torch.inf).amin(dim=1)
        tot = m0 + f1[:, c1]
        upd = tot < best
        best = torch.where(upd, tot, best)
        bm0 = torch.where(upd, m0, bm0)
        bv1 = torch.where(upd, c1v, bv1)
    # recover the winning origin in one pass: re-apply the winner's
    # feasibility at destination bv1 and pick the smallest candidate
    # value attaining the tracked origin minimum bm0
    bv0 = torch.where(feasible(bv1) & (f0 == bm0[:, None]), cand,
                      torch.inf).amin(dim=1)
    bv0 = torch.where(torch.isfinite(bv0), bv0, 0.0)
    return best, [bv0, bv1]
