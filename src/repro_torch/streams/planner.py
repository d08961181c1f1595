"""Vectorized proactive fleet planner — ``core.shp.plan_placement`` over M
heterogeneous cost models in one numpy pass.

The paper's tractability claim is that r* is closed-form per stream
(eq. 17/21 + the eq. 22 validity gate), so a fleet of thousands of tenant
streams can be planned proactively before any document arrives — no
per-stream optimization loop, just array arithmetic over the
struct-of-arrays view of the cost models. ``plan_fleet`` must agree
stream-for-stream with ``shp.plan_placement(cm)`` (tests assert this);
it evaluates the same four candidate strategies in the same precedence
order using the paper's logarithmic approximations.

Fleets may mix tier depths: ``plan_fleet_mixed`` routes each stream's cost
model to the matching vectorized solver (this legacy two-tier pass, or the
multi-threshold ``shp.plan_ntier_arrays`` grouped by tier count) and
returns one uniform per-stream boundary-vector plan.

Constraints (``core.constraints``) thread through both entry points as
vectorized feasibility masks over the (M, T) boundary batch. Fleet-shared
capacities (``TierCapacity(shared=True)``) are split across tenants by a
water-filling pass (:func:`waterfill`): plan unconstrained, measure each
stream's desired occupancy high-water mark on the shared tier, cap the
binding streams at the common water level λ with Σ min(desired, λ) = C,
and re-plan only those — the fleet then never oversubscribes C.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import constraints as constraints_mod, shp
from repro_torch.core.constraints import ConstraintSet, TierCapacity
from repro_torch.core.costs import NTierCostModel, TwoTierCostModel
from repro_torch.core.placement import Policy

# Column order = candidate order in shp.plan_placement (ties resolve the
# same way: first minimum wins).
STRATEGIES = ("all_tier_a", "all_tier_b", "two_tier_no_migration",
              "two_tier_migration")


@dataclass(frozen=True)
class FleetCosts:
    """Struct-of-arrays view of M ``TwoTierCostModel``s (all (M,) float64,
    except ``n``/``k`` which are the workload integers as float)."""

    cw_a: np.ndarray
    cw_b: np.ndarray
    cr_a: np.ndarray
    cr_b: np.ndarray
    cs_a: np.ndarray
    cs_b: np.ndarray
    n: np.ndarray
    k: np.ndarray
    reads_per_window: np.ndarray

    @classmethod
    def from_models(cls, models: Sequence[TwoTierCostModel]) -> "FleetCosts":
        f = lambda attr: np.array([getattr(m, attr) for m in models], np.float64)
        return cls(
            cw_a=f("cw_a"), cw_b=f("cw_b"), cr_a=f("cr_a"), cr_b=f("cr_b"),
            cs_a=f("cs_a"), cs_b=f("cs_b"),
            n=np.array([m.workload.n_docs for m in models], np.float64),
            k=np.array([m.workload.k for m in models], np.float64),
            reads_per_window=np.array(
                [m.workload.reads_per_window for m in models], np.float64),
        )

    @property
    def m(self) -> int:
        return self.cw_a.shape[0]


@dataclass(frozen=True)
class FleetPlan:
    """Per-stream outcome of the vectorized decision procedure.

    Under constraints the family candidates are planned by the
    constrained N-tier pass: ``r_no_migration``/``r_migration`` then hold
    the *feasibility-clamped* chosen boundary (not the raw eq. 17/21
    stationary points), unchosen family columns of ``totals`` are +inf,
    and ``feasible`` flags streams with any feasible plan at all.
    """

    strategy_idx: np.ndarray  # (M,) int — index into STRATEGIES
    r: np.ndarray  # (M,) absolute changeover index of the chosen strategy
    totals: np.ndarray  # (M, 4) expected cost per candidate (+inf if gated)
    r_no_migration: np.ndarray  # (M,) eq. 17 stationary point (may be inf/nan)
    r_migration: np.ndarray  # (M,) eq. 21 stationary point
    n_docs: np.ndarray  # (M,)
    feasible: Optional[np.ndarray] = None  # (M,) bool (None = unconstrained)

    @property
    def m(self) -> int:
        return self.strategy_idx.shape[0]

    def strategy(self, i: int) -> str:
        return STRATEGIES[int(self.strategy_idx[i])]

    def migrate(self, i: int) -> bool:
        return self.strategy(i) == "two_tier_migration"

    @property
    def best_total(self) -> np.ndarray:
        return self.totals[np.arange(self.m), self.strategy_idx]

    def policy(self, i: int) -> Policy:
        """The executable per-stream policy (same mapping as
        ``placement.from_plan``)."""
        s = self.strategy(i)
        if s == "all_tier_a":
            return Policy(r=float(self.n_docs[i]), name="all_a")
        if s == "all_tier_b":
            return Policy(r=0.0, name="all_b")
        if s == "two_tier_no_migration":
            return Policy(r=float(self.r_no_migration[i]), name="algoC_nomig")
        return Policy(r=float(self.r_migration[i]), migrate_at_r=True,
                      name="algoC_mig")

    def strategy_histogram(self) -> dict:
        return {s: int(np.sum(self.strategy_idx == i))
                for i, s in enumerate(STRATEGIES)}


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        out = num / den
    return np.where(den == 0.0, np.nan, out)


def plan_fleet(models_or_costs, constraints: Optional[ConstraintSet] = None,
               lat: Optional[np.ndarray] = None, *,
               device=None) -> FleetPlan:
    """Plan every stream in the fleet in one vectorized pass.

    Accepts a sequence of ``TwoTierCostModel`` or a prebuilt ``FleetCosts``.
    Uses the paper's approximate (logarithmic) forms, i.e. matches
    ``shp.plan_placement(cm, exact=False)`` per stream.

    A non-empty ``constraints`` routes the fleet through the constrained
    N-tier array pass (the resource-augmented solver with vectorized
    feasibility masks over the (M, 2) boundary batch). ``lat`` supplies
    per-tier read latencies ((2,) or (M, 2)) for ``ReadLatencySLO``
    constraints — the legacy two-tier cost models carry none. Byte-
    denominated capacities need document sizes: plan those fleets via
    ``plan_fleet_mixed`` with full cost models. ``device`` goes to
    ``shp.plan_ntier_arrays`` (its "auto" rule picks the solver).
    """
    fc = (models_or_costs if isinstance(models_or_costs, FleetCosts)
          else FleetCosts.from_models(models_or_costs))
    if constraints is not None and not constraints.empty:
        if constraints.shared_capacities:
            raise ValueError(
                "fleet-shared capacities need the water-filling pass — "
                "plan via plan_fleet_mixed")
        if any(c.max_bytes is not None for c in constraints.capacities):
            raise ValueError(
                "byte-denominated capacities need document sizes — plan "
                "via plan_fleet_mixed with full cost models")
        return _plan_fleet_constrained(fc, constraints, lat, device)
    n, k, rpw = fc.n, fc.k, fc.reads_per_window
    log_n_over_k = np.log(n / k)

    # single-tier candidates (cost_single_tier, approx)
    w_total = k * (1.0 + log_n_over_k)
    tot_a = w_total * fc.cw_a + rpw * k * fc.cr_a + k * fc.cs_a
    tot_b = w_total * fc.cw_b + rpw * k * fc.cr_b + k * fc.cs_b

    # eq. 17 / eq. 21 stationary points + eq. 22 validity gate (incl. the
    # second-order condition cw_A < cw_B — see shp.r_is_valid)
    r_nm = _safe_div(fc.cw_a - fc.cw_b, (fc.cr_b - fc.cr_a) * rpw) * n
    r_mg = _safe_div(fc.cw_a - fc.cw_b, fc.cs_b - fc.cs_a) * n
    second_order = fc.cw_a < fc.cw_b

    def _two_tier(r, migrate):
        valid = (np.isfinite(r) & (k < r) & (r < n) & second_order)
        rs = np.where(valid, r, k + 1.0)  # placeholder keeps logs finite
        wa = k * (1.0 + np.log(rs / k))
        wb = k * (np.log(n) - np.log(rs))
        writes = wa * fc.cw_a + wb * fc.cw_b
        rn = rs / n
        if migrate:
            storage = k * (rn * fc.cs_a + (1.0 - rn) * fc.cs_b)
            total = writes + storage + k * (fc.cr_a + fc.cw_b)
        else:
            reads = rpw * k * (rn * fc.cr_a + (1.0 - rn) * fc.cr_b)
            total = writes + reads + k * np.maximum(fc.cs_a, fc.cs_b)
        return np.where(valid, total, np.inf)

    totals = np.stack(
        [tot_a, tot_b, _two_tier(r_nm, False), _two_tier(r_mg, True)], axis=1)
    idx = np.argmin(totals, axis=1)
    r_chosen = np.select(
        [idx == 0, idx == 1, idx == 2], [n, np.zeros_like(n), r_nm], r_mg)
    return FleetPlan(strategy_idx=idx, r=r_chosen, totals=totals,
                     r_no_migration=r_nm, r_migration=r_mg, n_docs=n)


def _plan_fleet_constrained(fc: FleetCosts, cset: ConstraintSet,
                            lat: Optional[np.ndarray], device) -> FleetPlan:
    """The constrained two-tier fleet pass: stack the struct-of-arrays
    view into (M, 2) tier columns and run the constrained N-tier solver,
    mapping its boundary-vector plans back onto the four legacy candidate
    strategies."""
    m = fc.m
    cw = np.stack([fc.cw_a, fc.cw_b], axis=1)
    cr = np.stack([fc.cr_a, fc.cr_b], axis=1)
    cs = np.stack([fc.cs_a, fc.cs_b], axis=1)
    # (M, 2) constraint views are broadcast, not materialized: the solver
    # consumes them read-only, so one (2,)/scalar allocation serves the
    # whole fleet instead of three fresh M-row arrays per call
    cap = np.broadcast_to(cset.capacity_array(2, 0.0), (m, 2))
    lat_arr = np.broadcast_to(
        np.zeros(2) if lat is None else np.asarray(lat, np.float64),
        (m, 2))
    slo = np.broadcast_to(np.float64(cset.max_read_latency), (m,))
    out = shp.plan_ntier_arrays(cw, cr, cs, fc.n, fc.k, fc.reads_per_window,
                                cap=cap, lat=lat_arr, slo=slo,
                                device=device)
    feasible = np.isfinite(out["total"])
    r = out["bounds"][:, 0]
    mig = out["migrate"]
    # map the boundary plan onto the legacy candidate columns
    single_a = ~mig & (r >= fc.n)
    single_b = ~mig & (r <= 0.0)
    idx = np.select([single_a, single_b, ~mig], [0, 1, 2], 3)
    idx = np.where(feasible, idx, 0)
    totals = np.full((m, 4), np.inf)
    totals[np.arange(m), idx] = np.where(feasible, out["total"], np.inf)
    return FleetPlan(strategy_idx=idx, r=r, totals=totals,
                     r_no_migration=np.where(mig, np.nan, r),
                     r_migration=np.where(mig, r, np.nan), n_docs=fc.n,
                     feasible=feasible)


# ---------------------------------------------------------------------------
# Fleet-shared capacity: the water-filling split
# ---------------------------------------------------------------------------

def waterfill(desired: np.ndarray, budget: float, *,
              mesh=None) -> np.ndarray:
    """Split a shared budget across tenants: each stream gets
    ``min(desired_i, λ)`` with the water level λ chosen so the grants sum
    to the budget (all ``desired`` granted when they already fit).
    Returns the (M,) per-stream caps.

    The exact host law lives in ``core.constraints.waterfill_grants``
    (sort + prefix scan — one host view of the whole fleet). Under a
    fleet mesh of more than one shard the desires stay sharded and λ is
    found on the devices by a bisection whose partial sums are added on
    shard 0 (``parallel.fleet.waterfill_sharded``)."""
    if mesh is not None:
        from repro_torch.parallel import fleet
        if fleet.n_shards(mesh) > 1:
            return fleet.waterfill_sharded(desired, budget, mesh)
    return constraints_mod.waterfill_grants(desired, budget)


# ---------------------------------------------------------------------------
# Mixed-depth fleets: two-tier and N-tier cost models side by side
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MixedFleetPlan:
    """Per-stream boundary-vector plans for a fleet mixing tier depths.

    Two-tier streams are planned by the legacy ``plan_fleet`` pass (their
    single boundary is the chosen r); N-tier streams by the vectorized
    multi-threshold solver, grouped by tier count. Constrained fleets
    route every stream (two-tier included, via ``as_ntier``) through the
    constrained N-tier pass; streams with no feasible plan carry
    strategy ``"infeasible"`` and ``totals = +inf``.
    """

    boundaries: Tuple[Tuple[float, ...], ...]
    migrate_flags: np.ndarray  # (M,) bool
    strategies: Tuple[str, ...]
    totals: np.ndarray  # (M,) expected cost of the chosen strategy

    @property
    def m(self) -> int:
        return len(self.boundaries)

    def strategy(self, i: int) -> str:
        return self.strategies[i]

    def migrate(self, i: int) -> bool:
        return bool(self.migrate_flags[i])

    def feasible(self, i: int) -> bool:
        return bool(np.isfinite(self.totals[i]))

    def policy(self, i: int) -> Policy:
        if not self.feasible(i):
            raise ValueError(f"stream {i} has no feasible plan under its "
                             "constraints")
        return Policy(boundaries=self.boundaries[i],
                      migrate_at_r=self.migrate(i), name=self.strategies[i])

    def strategy_histogram(self) -> dict:
        out: dict = {}
        for s in self.strategies:
            out[s] = out.get(s, 0) + 1
        return out


def _as_ntier_models(models) -> List[NTierCostModel]:
    out = []
    for i, cm in enumerate(models):
        if isinstance(cm, TwoTierCostModel):
            out.append(cm.as_ntier())
        elif isinstance(cm, NTierCostModel):
            out.append(cm)
        else:
            raise TypeError(f"stream {i}: unsupported cost model {type(cm)}")
    return out


def _plan_mixed_ntier(nt_models, csets, boundaries, migrate,
                      strategies, totals, only=None, device=None) -> None:
    """One N-tier pass per distinct tier count (constrained when the
    per-stream sets say so), writing the per-stream results in place.
    ``only`` restricts to a subset of stream indices (the unconstrained
    route's N-tier leg, and the water-filling re-plan)."""
    by_t: dict = {}
    idx_iter = range(len(nt_models)) if only is None else only
    for i in idx_iter:
        by_t.setdefault(nt_models[i].t, []).append(i)
    for t, idxs in sorted(by_t.items()):
        tot, bounds, mig, strats = shp.plan_ntier_batch(
            [nt_models[i] for i in idxs],
            constraints=[csets[i] for i in idxs], device=device)
        for j, i in enumerate(idxs):
            boundaries[i] = tuple(float(b) for b in bounds[j])
            migrate[i] = bool(mig[j])
            strategies[i] = strats[j]
            totals[i] = tot[j]


def plan_fleet_mixed(models: Sequence[TwoTierCostModel | NTierCostModel],
                     constraints=None, *, mesh=None,
                     device=None) -> MixedFleetPlan:
    """Plan a heterogeneous fleet in a handful of vectorized passes: one
    legacy two-tier pass plus one N-tier pass per distinct tier count.

    ``constraints`` is a fleet-wide ``ConstraintSet`` or one per stream.
    Fleet-wide shared capacities (``TierCapacity(shared=True)``) are split
    across tenants by water-filling: plan with the per-stream constraints,
    measure each stream's expected occupancy high-water mark on the shared
    tier, grant ``min(desired, λ)`` with Σ grants = C, and re-plan only
    the binding streams under their grant — the fleet's total expected
    occupancy then never exceeds C (asserted by the property tests).

    ``device`` goes to ``shp.plan_ntier_arrays`` for every N-tier pass
    (the CUDA device plans fleets on the card; see its "auto" rule).
    ``mesh`` (a ``parallel.fleet.FleetMesh``) makes it the active fleet
    mesh for the call, so the device solves run per shard on the shards'
    devices, and the shared-capacity water-filling runs sharded.
    """
    if mesh is not None:
        from repro_torch.parallel import fleet
        if fleet.get_fleet_mesh() is not mesh:
            with fleet.use_fleet_mesh(mesh):
                return plan_fleet_mixed(models, constraints, mesh=mesh,
                                        device=device)
    m = len(models)
    boundaries: List[Tuple[float, ...]] = [()] * m
    migrate = np.zeros(m, bool)
    strategies: List[str] = [""] * m
    totals = np.zeros(m, np.float64)
    shared: Tuple[TierCapacity, ...] = ()
    if constraints is None:
        per_stream = None
    elif isinstance(constraints, ConstraintSet):
        shared = constraints.shared_capacities
        base = ConstraintSet(*(c for c in constraints if c not in shared))
        per_stream = None if (base.empty and not shared) else [base] * m
    else:
        if len(constraints) != m:
            raise ValueError("need one ConstraintSet per stream")
        per_stream = [c if c is not None else ConstraintSet()
                      for c in constraints]
        if any(c.shared_capacities for c in per_stream):
            raise ValueError(
                "shared capacities are fleet-wide — pass one ConstraintSet "
                "for the whole fleet, not per-stream sets")

    if per_stream is None:
        # unconstrained: the original two-pass route (bit-stable)
        two_idx = [i for i, cm in enumerate(models)
                   if isinstance(cm, TwoTierCostModel)]
        if two_idx:
            plan = plan_fleet([models[i] for i in two_idx], device=device)
            for j, i in enumerate(two_idx):
                boundaries[i] = (float(plan.r[j]),)
                migrate[i] = plan.migrate(j)
                strategies[i] = plan.strategy(j)
                totals[i] = plan.best_total[j]
        ntier_idx = []
        for i, cm in enumerate(models):
            if isinstance(cm, NTierCostModel):
                ntier_idx.append(i)
            elif not isinstance(cm, TwoTierCostModel):
                raise TypeError(
                    f"stream {i}: unsupported cost model {type(cm)}")
        _plan_mixed_ntier(models, [None] * m, boundaries, migrate,
                          strategies, totals, only=ntier_idx,
                          device=device)
        return MixedFleetPlan(boundaries=tuple(boundaries),
                              migrate_flags=migrate,
                              strategies=tuple(strategies), totals=totals)

    nt_models = _as_ntier_models(models)
    csets = list(per_stream)
    _plan_mixed_ntier(nt_models, csets, boundaries, migrate,
                      strategies, totals, device=device)
    done_tiers: List[int] = []
    for cap_c in sorted(shared, key=lambda c: c.tier):
        if cap_c.max_bytes is not None:
            raise NotImplementedError(
                "shared capacities are document-denominated; convert byte "
                "budgets per tenant before planning")

        def occupancy_on(tier: int) -> np.ndarray:
            occ = np.zeros(m)
            for i, nt in enumerate(nt_models):
                if tier < nt.t and np.isfinite(totals[i]):
                    occ[i] = constraints_mod.peak_occupancy(
                        boundaries[i], nt.workload.n_docs, nt.workload.k,
                        migrate[i])[tier]
            return occ

        desired = occupancy_on(cap_c.tier)
        if desired.sum() <= cap_c.max_docs:
            done_tiers.append(cap_c.tier)
            continue
        grants = waterfill(desired, cap_c.max_docs, mesh=mesh)
        binding = np.flatnonzero(desired > grants * (1 + 1e-12))
        # freeze the re-planned streams' usage of every already-balanced
        # shared tier at its current level, so re-planning for this tier
        # cannot push an earlier tier back over its budget
        frozen = {t: occupancy_on(t) for t in done_tiers}
        for i in binding:
            extra = [TierCapacity(cap_c.tier, float(grants[i]))]
            extra += [TierCapacity(t, float(frozen[t][i]))
                      for t in done_tiers]
            csets[i] = ConstraintSet(*csets[i], *extra)
        _plan_mixed_ntier(nt_models, csets, boundaries, migrate,
                          strategies, totals, only=list(binding),
                          device=device)
        done_tiers.append(cap_c.tier)
    return MixedFleetPlan(boundaries=tuple(boundaries),
                          migrate_flags=migrate,
                          strategies=tuple(strategies), totals=totals)
