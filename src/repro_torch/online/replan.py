"""Mid-window re-planning: re-run the constrained boundary solve over the
*remaining suffix* of a window once drift is detected — the port of the
reference's ``online.replan``: the host code copied, with the suffix
solve dispatched to the port's ``online.replan_device`` on a CUDA device.

The a-priori plan (``core.shp``) minimizes the full-window expectation
under the i.u.d. entry law K/(i+1). When the drift detector flags a
stream at position n0 with rate-multiplier estimate ρ, the suffix problem
conditions both laws on the observed prefix:

* entries among the remaining docs follow the weighted-record law
  conditioned on the detector's *instantaneous* observed/expected ratio
  ρ: future entries ``W(b) = K·ln(1 + ρ(b − n0)/n0)`` — the underlying
  drift weight cancels, so ρ is a sufficient statistic and the burst the
  reservoir bar has already absorbed is never double-counted (a
  persistent-multiplier ``ρK/(i+1)`` model would keep planning for it).
  The form stays separable log-piecewise, with eq. 17/21-style
  stationary points in the shifted coordinate ``u = S(b)``;
* the final top-K read weights survivor locations by the same drifted
  density (weight 1 over the seen prefix, ρ over the suffix, normalized
  by ``S_N = n0 + ρ(N − n0)`` — the weighted-record survivor law);
* boundary moves that cross *seen* indices re-tier existing residents:
  each such move is billed per boundary hop like eq. 19
  (promote across boundary j: ``cr_j + cw_{j-1}``; demote:
  ``cr_{j-1} + cw_j``), with residents uniform over the prefix at density
  ``min(n0, K)/n0`` — the migration bill. Moves are separable per
  boundary, so the whole suffix objective still solves on the planner's
  monotone candidate grid (``shp.solve_separable_terms``), including the
  capacity/SLO feasibility structure of a ``ConstraintSet``.

``Replanner.replan`` solves per tier subset (degenerate tiers collapse,
excluded tiers relocate their residents — billed), compares against the
suffix cost of keeping the old boundaries, and applies the delta only
when the expected suffix savings clear the migration bill plus a
hysteresis margin. Migrating (cascade) streams are left untouched: their
cost is dominated by the constant cascade fee and the floor semantics of
a mid-cascade re-plan are ambiguous. Storage keeps the planner's
most-expensive-used-tier bound convention, so old-vs-new suffix costs are
compared like for like.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import constraints as constraints_mod
from repro_torch.core import shp
from repro_torch.core.constraints import ConstraintSet
from repro_torch.core.costs import NTierCostModel, TwoTierCostModel

from .drift import DriftConfig

_MOVE_TOL = 1e-6  # docs — boundary moves below this re-tier nobody


@dataclass(frozen=True)
class ReplanConfig:
    """Online re-planning policy knobs (the engine's ``replan=`` value)."""

    drift: DriftConfig = field(default_factory=DriftConfig)
    min_rel_saving: float = 0.01  # hysteresis: required relative saving
    allow_moves: bool = True  # permit billed resident relocation


@dataclass
class ReplanDecision:
    """Outcome of one re-planning pass over the flagged streams."""

    rows: np.ndarray  # (R,) caller-side stream indices
    n_seen: np.ndarray  # (R,) docs observed at re-plan time
    rho: np.ndarray  # (R,) rate-multiplier estimates used
    old_bounds: List[Tuple[float, ...]]
    new_bounds: List[Tuple[float, ...]]
    applied: np.ndarray  # (R,) bool
    considered: np.ndarray  # (R,) bool — False: structurally skipped
    feasible: np.ndarray  # (R,) bool — constrained suffix solve succeeded
    suffix_cost_old: np.ndarray  # (R,) expected suffix cost, old plan
    suffix_cost_new: np.ndarray  # (R,) expected suffix cost, new plan
    move_bill: np.ndarray  # (R,) expected relocation cost inside new
    expected_moves: np.ndarray  # (R,) expected docs relocated
    suffix_occupancy: List  # per row: (T,) projected suffix peaks, or None

    @property
    def any_applied(self) -> bool:
        return bool(self.applied.any())


def _as_ntier(cm) -> NTierCostModel:
    return cm.as_ntier() if isinstance(cm, TwoTierCostModel) else cm


def _mass(x, anchor, rho, n):
    """Survivor weight mass of [0, x): weight 1 before the (estimated)
    drift onset ``anchor``, ρ after."""
    return (np.minimum(x, anchor) + rho * (np.clip(x, anchor, n) - anchor))


def _w_suffix(x, n0, rho, k):
    """E[reservoir entries among suffix docs [n0, x)]: an unfull
    reservoir admits everything, then ``K·ln(1 + ρ(x − n0)/n0)``.

    This is the weighted-record law conditioned on the *instantaneous*
    observed/expected ratio ρ at n0: if a sustained weight θ produced
    current ratio ρ = θ·n0/S(n0), then S(x) = S(n0) + θ(x − n0) gives
    future entries K·ln(S(x)/S(n0)) = K·ln(1 + ρ(x − n0)/n0) — θ cancels,
    so ρ alone is sufficient and no onset estimate is needed. Reduces to
    the planner's ``W(x) − W(n0)`` at ρ = 1. Broadcasts."""
    x = np.maximum(x, n0)
    head = np.maximum(np.minimum(x, k) - n0, 0.0)
    start = np.maximum(n0, k)
    u = start + rho * (np.maximum(x, start) - start)
    return head + k * np.log(u / start)


def _reloc_terms(c, b0_j, n0, dens, price_up, price_dn, allow_moves):
    """(R, C) expected relocation cost of moving full boundary j from
    ``b0_j`` to each candidate value (hop-priced, residents uniform over
    the seen prefix)."""
    delta = np.clip(c, 0.0, n0[:, None]) - np.clip(b0_j, 0.0, n0)[:, None]
    cost = dens[:, None] * np.where(
        delta > 0, delta * price_up[:, None], -delta * price_dn[:, None])
    if not allow_moves:
        return np.where(np.abs(delta) > _MOVE_TOL, np.inf, 0.0)
    return cost


def _pinned_reloc_const(b0, n0, dens, cr, cw, sa, t, allow_moves):
    """(R,) relocation cost of the boundaries a subset pins: leading
    boundaries (j <= sa[0]) collapse to 0 (demoting the residents below
    them), trailing ones (j > sa[-1]) to N (promoting)."""
    r = b0.shape[0]
    const = np.zeros(r)
    moves = np.zeros(r)
    for j in range(1, sa[0] + 1):
        cnt = dens * np.clip(b0[:, j - 1], 0.0, n0)
        const += cnt * (cr[:, j - 1] + cw[:, j])
        moves += cnt
    for j in range(sa[-1] + 1, t):
        cnt = dens * (n0 - np.clip(b0[:, j - 1], 0.0, n0))
        const += cnt * (cr[:, j] + cw[:, j - 1])
        moves += cnt
    if not allow_moves:
        const = np.where(moves > _MOVE_TOL, np.inf, 0.0)
    return const, moves


def relocation_bill(b0, b_new, n0, k, cr, cw):
    """(bill (R,), moves (R,)) expected relocation cost/count of applying
    boundary vector ``b_new`` over ``b0`` at position ``n0`` — the same
    hop-priced law the solver's terms use, evaluated at one point."""
    b0 = np.asarray(b0, np.float64)
    b_new = np.asarray(b_new, np.float64)
    n0 = np.asarray(n0, np.float64)
    dens = np.minimum(n0, np.asarray(k, np.float64)) / np.maximum(n0, 1.0)
    bill = np.zeros(b0.shape[0])
    moves = np.zeros(b0.shape[0])
    for j in range(1, b0.shape[1] + 1):
        delta = (np.clip(b_new[:, j - 1], 0.0, n0)
                 - np.clip(b0[:, j - 1], 0.0, n0))
        price_up = cr[:, j] + cw[:, j - 1]
        price_dn = cr[:, j - 1] + cw[:, j]
        bill += dens * np.where(delta > 0, delta * price_up,
                                -delta * price_dn)
        moves += dens * np.abs(delta)
    return bill, moves


def suffix_cost(cw, cr, cs, n, k, rpw, n0, rho, bounds) -> np.ndarray:
    """(R,) expected cost of the window suffix under ``bounds`` with no
    relocation: drift-conditioned writes, weighted survivor read, and the
    most-expensive-used-tier rental bound (the planner's convention)."""
    r, t = cw.shape
    edges = np.concatenate([np.zeros((r, 1)),
                            np.asarray(bounds, np.float64),
                            n[:, None]], axis=1)
    wmax = _w_suffix(edges, n0[:, None], rho[:, None], k[:, None])
    writes = ((wmax[:, 1:] - wmax[:, :-1]) * cw).sum(axis=1)
    s_n = n0 + rho * (n - n0)
    mass = _mass(edges, n0[:, None], rho[:, None], n[:, None])
    reads = ((mass[:, 1:] - mass[:, :-1]) * cr).sum(axis=1) \
        * (rpw * k / s_n)
    used = np.diff(edges, axis=1) > 0
    storage = k * np.max(np.where(used, cs, -np.inf), axis=1)
    return writes + reads + storage


class Replanner:
    """Constrained suffix re-solver for a (sub)fleet of cost models.

    ``models[i]`` is stream i's cost model (two-tier models are viewed
    through ``as_ntier``; entries may be None for streams placed
    explicitly — those are never re-planned). ``constraints`` is a
    fleet-wide ``ConstraintSet`` or one per stream; fleet-shared
    capacities are not supported (their water-filled grants live in the
    a-priori fleet plan, not here).

    ``backend`` picks the suffix solver as ``shp.plan_ntier_arrays``
    picks the planner's: "numpy" runs the NumPy loop; "device" runs
    ``replan_device`` on ``device`` (the CUDA card unless the caller
    names another; raises without one, and for T > 4); None or "auto"
    runs ``replan_device`` when the device (``device``, else the card if
    there is one) is CUDA and the hierarchy has 2 to 4 tiers, and the
    NumPy loop otherwise.
    """

    def __init__(self, models: Sequence, constraints=None,
                 config: Optional[ReplanConfig] = None, backend=None,
                 device=None):
        if backend == "jax":
            raise ValueError("the port's device re-solve backend is "
                             "'device', not 'jax'")
        if backend not in (None, "auto", "numpy", "device"):
            raise ValueError(f"unknown re-plan backend {backend!r}")
        self.models = [None if cm is None else _as_ntier(cm)
                       for cm in models]
        self.config = config if config is not None else ReplanConfig()
        self.backend = backend  # None/"auto" | "device" | "numpy"
        self.device = device
        m = len(self.models)
        if constraints is None or isinstance(constraints, ConstraintSet):
            self.csets = [constraints] * m
        else:
            if len(constraints) != m:
                raise ValueError("need one ConstraintSet per stream")
            self.csets = list(constraints)
        for cset in self.csets:
            if cset is not None and cset.shared_capacities:
                raise NotImplementedError(
                    "fleet-shared capacities re-plan through the a-priori "
                    "water-filling pass, not the online re-planner")
        # constraint resolution and the struct-of-arrays model view are
        # pure in (model, cset): compile once at construction —
        # re-resolving and re-stacking per replan() call dominated the
        # whole suffix re-solve (~2/3 of the wall time)
        self._compiled = [None if cm is None
                          else shp.resolve_constraints(cm, cset)
                          for cm, cset in zip(self.models, self.csets)]
        self._row_pos: Dict[int, int] = {}
        by_t: Dict[int, List[int]] = {}
        for i, cm in enumerate(self.models):
            if cm is not None:
                by_t.setdefault(cm.t, []).append(i)
        self._stacks: Dict[int, dict] = {}
        for t, rows in by_t.items():
            ms = [self.models[i] for i in rows]
            self._stacks[t] = {
                "cw": np.stack([cm.cw for cm in ms]),
                "cr": np.stack([cm.cr for cm in ms]),
                "cs": np.stack([cm.cs for cm in ms]),
                "n": np.array([float(cm.workload.n_docs) for cm in ms]),
                "k": np.array([float(cm.workload.k) for cm in ms]),
                "rpw": np.array([cm.workload.reads_per_window
                                 for cm in ms]),
                "cap": np.stack([self._compiled[i][0] for i in rows]),
                "lat": np.stack([self._compiled[i][1] for i in rows]),
                "slo": np.array([self._compiled[i][2] for i in rows]),
            }
            for pos, i in enumerate(rows):
                self._row_pos[i] = pos
        self._t_of = np.array([0 if cm is None else cm.t
                               for cm in self.models], np.int64)
        self._ndocs_of = np.array(
            [0.0 if cm is None else float(cm.workload.n_docs)
             for cm in self.models])

    # ---- the suffix solve ------------------------------------------------

    def _solve_group(self, idxs, n_seen, rho, b0,
                     exclude_tiers=frozenset()):
        """Re-solve one uniform-tier-count group. Returns (total (R,),
        bounds (R, t-1), cost_old (R,)).

        Dispatches the per-subset suffix solve to the device path
        (``online.replan_device``, the ``kernels.plan_solve`` reduction)
        for hierarchies the exact enumeration covers, under the rule of
        the class docstring; the NumPy loop below remains the oracle
        reference (``backend="numpy"``) the device path is tested
        against.

        ``exclude_tiers`` (tier-outage degradation) drops every tier
        subset that touches a masked tier, so the chosen plan gives the
        failed tier zero width over the whole window — residents are
        relocated off it by the caller's ``apply_boundaries`` and no
        future doc lands there. The enumeration runs on the NumPy oracle
        path (the device program enumerates the full subset lattice)."""
        cfg = self.config
        exclude_tiers = frozenset(exclude_tiers)
        t = self.models[idxs[0]].t
        r = len(idxs)
        st = self._stacks[t]
        pos = np.asarray([self._row_pos[i] for i in idxs], np.int64)
        cw, cr, cs = st["cw"][pos], st["cr"][pos], st["cs"][pos]
        n, k, rpw = st["n"][pos], st["k"][pos], st["rpw"][pos]
        cap, lat, slo = st["cap"][pos], st["lat"][pos], st["slo"][pos]
        constrained = not constraints_mod.trivial(cap, slo)
        n0 = np.asarray(n_seen, np.float64)
        rho = np.asarray(rho, np.float64)
        backend = self.backend if self.backend is not None else "auto"
        if not exclude_tiers and (
                backend == "device" or (
                    backend == "auto"
                    and shp._auto_device(self.device).type == "cuda")):
            from . import replan_device
            if replan_device.available(t):
                total, bounds, cost_old = replan_device.solve_group(
                    cw, cr, cs, n, k, rpw, cap, lat, slo, n0, rho,
                    np.asarray(b0, np.float64),
                    allow_moves=cfg.allow_moves, device=self.device)
                return total, bounds, cost_old, (cw, cr, n0, k, n, cap)
            if backend == "device":
                raise ValueError(
                    f"device suffix re-solve unavailable for t={t}")
        s_n = n0 + rho * (n - n0)
        dens = np.minimum(n0, k) / np.maximum(n0, 1.0)
        start = np.maximum(n0, k)
        w_n = _w_suffix(n, n0, rho, k)
        best_total = np.full(r, np.inf)
        best_bounds = np.zeros((r, t - 1))
        for sub in shp._tier_subsets(t):
            if exclude_tiers and exclude_tiers.intersection(sub):
                continue  # tier outage: subsets touching a masked tier
            sa = np.asarray(sub)
            ts = sa.shape[0]
            lin = (rpw * k * rho / s_n)[:, None] * cr[:, sa]
            kw = (dict(cap_s=cap[:, sa], lat_s=lat[:, sa], slo=slo)
                  if constrained else {})
            obj = shp.BoundaryObjective(cw_s=rho[:, None] * cw[:, sa],
                                        lin_s=lin, n=n, k=k, **kw)
            ok = obj.subset_feasible()
            reloc_const, _ = _pinned_reloc_const(b0, n0, dens, cr, cw, sa,
                                                 t, cfg.allow_moves)
            const = (w_n * cw[:, sa[-1]]
                     + rpw * k * cr[:, sa[-1]] + reloc_const
                     + k * np.max(cs[:, sa], axis=1))
            if ts == 1:
                interior, sub_bounds = np.zeros(r), np.zeros((r, 0))
            else:
                # stationary points of the drifted write law live in the
                # shifted coordinate u = S(b): map the eq. 17/21-style
                # crossovers back through b = start + (u − start)/ρ
                ustars = shp._crossover_candidates(
                    cw[:, sa], lin, rho * k, np.zeros(r), np.inf)
                extra = [np.clip(n0, 0.0, n)]
                extra += [np.clip(start + (u - start) / rho, 0.0, n)
                          for u in ustars]
                extra += [np.clip(b0[:, j], 0.0, n)
                          for j in range(t - 1)]
                c = np.sort(np.concatenate(
                    [obj.candidates(), np.stack(extra, axis=1)], axis=1),
                    axis=1)
                fs = []
                for s in range(1, ts):
                    u, v = sa[s - 1], sa[s]
                    f = ((cw[:, u] - cw[:, v])[:, None]
                         * _w_suffix(c, n0[:, None], rho[:, None],
                                     k[:, None])
                         + ((cr[:, u] - cr[:, v]) * rpw * k / s_n)[:, None]
                         * _mass(c, n0[:, None], rho[:, None], n[:, None]))
                    for j in range(u + 1, v + 1):
                        f = f + _reloc_terms(
                            c, b0[:, j - 1], n0, dens,
                            cr[:, j] + cw[:, j - 1],
                            cr[:, j - 1] + cw[:, j], cfg.allow_moves)
                    fs.append(f)
                if obj.constrained:
                    base = obj.terms(c)
                    fs = [np.where(np.isfinite(bj), fj, np.inf)
                          for fj, bj in zip(fs, base)]
                interior, sub_bounds = shp.solve_separable_terms(obj, fs, c)
            total = np.where(ok, interior + const, np.inf)
            edges = np.concatenate([np.zeros((r, 1)), sub_bounds,
                                    n[:, None]], 1)
            widths = np.zeros((r, t))
            widths[:, sa] = np.diff(edges, axis=1)
            full = np.cumsum(widths, axis=1)[:, :-1]
            upd = total < best_total
            best_total = np.where(upd, total, best_total)
            best_bounds = np.where(upd[:, None], full, best_bounds)
        cost_old = suffix_cost(cw, cr, cs, n, k, rpw, n0, rho, b0)
        return best_total, best_bounds, cost_old, (cw, cr, n0, k, n, cap)

    def replan(self, rows, n_seen, rho, boundaries, migrate,
               hwm=None, exclude_tiers=frozenset(),
               force: bool = False) -> ReplanDecision:
        """Re-solve the flagged streams. ``rows`` index into the model
        list; ``boundaries[i]`` is each stream's current vector (its own
        tier depth); ``migrate`` flags cascade streams (skipped). ``rho``
        is the detector's *instantaneous* observed/expected entry-rate
        ratio — a sufficient statistic for the conditioned suffix laws
        (the underlying drift weight cancels). ``hwm`` ((R, >=T) metered
        occupancy high-water marks) conditions the occupancy check on the
        observed prefix: the projected suffix peak is
        ``max(analytic, observed)`` (``constraints.peak_occupancy_suffix``
        — a peak already witnessed under drift cannot be un-rung), and a
        re-solved plan whose projected peaks violate the capacities is
        reported infeasible so the caller can hand the tenant to
        admission control.

        ``exclude_tiers`` masks failed tiers out of the feasible subset
        lattice (tier-outage degradation); ``force`` applies every
        feasible re-solve regardless of the hysteresis margin — an
        evacuation is a feasibility decision, not a savings decision, so
        a costlier suffix plan must still be applied."""
        rows = np.asarray(rows, np.int64)
        n_seen = np.asarray(n_seen, np.float64)
        rho = np.asarray(rho, np.float64)
        migrate = np.asarray(migrate, bool)
        r = rows.shape[0]
        old = [tuple(boundaries[i]) for i in range(r)]
        new = list(old)
        applied = np.zeros(r, bool)
        feasible = np.ones(r, bool)
        cost_old = np.full(r, np.nan)
        cost_new = np.full(r, np.nan)
        bill = np.zeros(r)
        moves = np.zeros(r)
        suffix_occ: List = [None] * r
        t_of = self._t_of[rows]
        considered = ((t_of > 0) & ~migrate & (n_seen > 0)
                      & (n_seen < self._ndocs_of[rows]))
        groups: Dict[int, List[int]] = {}
        for j in np.flatnonzero(considered):
            groups.setdefault(int(t_of[j]), []).append(int(j))
        for t, idxs in sorted(groups.items()):
            b0 = np.array([old[j] for j in idxs], np.float64)
            total, bounds, c_old, (cw, cr, n0, k, n, cap) = \
                self._solve_group([rows[j] for j in idxs], n_seen[idxs],
                                  rho[idxs], b0,
                                  exclude_tiers=exclude_tiers)
            g_bill, g_moves = relocation_bill(b0, bounds, n0, k, cr, cw)
            feas = np.isfinite(total)
            occ = None
            if hwm is not None:
                hwm_g = np.zeros((len(idxs), t))
                for gi, j in enumerate(idxs):
                    row_hwm = np.asarray(hwm[j], np.float64)
                    hwm_g[gi, : min(t, row_hwm.shape[0])] = row_hwm[:t]
                occ = constraints_mod.peak_occupancy_suffix(bounds, n, k,
                                                            hwm_g)
                feas = feas & np.all(occ <= cap * (1 + 1e-9), axis=1)
            margin = self.config.min_rel_saving * np.maximum(
                np.abs(c_old), 1e-12)
            apply_g = feas & (force | (total < c_old - margin))
            ii = np.asarray(idxs, np.int64)
            feasible[ii] = feas
            cost_old[ii] = c_old
            cost_new[ii] = total
            ap = np.flatnonzero(apply_g)
            applied[ii[ap]] = True
            bill[ii[ap]] = g_bill[ap]
            moves[ii[ap]] = g_moves[ap]
            if occ is not None:
                for jj, j in enumerate(idxs):
                    suffix_occ[j] = occ[jj]
            blist = bounds.tolist()
            for jj in ap:
                new[idxs[jj]] = tuple(blist[jj])
        return ReplanDecision(rows=rows, n_seen=n_seen, rho=rho,
                              old_bounds=old, new_bounds=new,
                              applied=applied, considered=considered,
                              feasible=feasible,
                              suffix_cost_old=cost_old,
                              suffix_cost_new=cost_new, move_bill=bill,
                              expected_moves=moves,
                              suffix_occupancy=suffix_occ)
