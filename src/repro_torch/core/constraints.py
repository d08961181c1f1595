"""Pluggable placement constraints — per-tier capacities and read-path
SLOs layered on top of the paper's unconstrained closed forms.

The paper's planner (eqs. 17/21) assumes every tier has unbounded capacity
and free, instant reads. Production hierarchies break both assumptions:
a hot NVMe/HBM tier holds C_t documents, and archival tiers (Glacier-style)
serve reads with retrieval latencies that a consumer SLO bounds. Following
the stochastic-submodular view of capacity-constrained tiering (Yun et al.
2020) and memory-bounded k-secretary placement (Qiao & Zhang 2025), this
module makes bounded resources first-class:

* ``TierCapacity`` — tier t holds at most C_t documents (or bytes) at any
  instant, measured as the reservoir's expected occupancy high-water mark.
* ``ReadLatencySLO`` — the expected per-survivor read latency at window end
  must not exceed a bound, with per-tier latencies from ``TierSpec``.
* ``ConstraintSet`` — an ordered bundle the planning stack consumes: the
  constrained planner (``shp.plan_ntier_arrays`` with ``cap/lat/slo``),
  the brute-force feasible-grid verifier, the fleet planner's shared-
  capacity water-filling pass, and reconciliation-time violation checks
  (``core.simulator`` / ``streams.metering``) all speak this vocabulary.

Any object implementing the ``Constraint`` protocol (``feasible(cm,
bounds, migrate)``) plugs into the generic feasibility/verification path;
the planner additionally fast-paths the two concrete types into exact
masks and a resource-augmented DP.

Occupancy law (derived from the paper's i.u.d. assumption): at stream
position j the reservoir's members are uniformly distributed over the
prefix, so a static tier spanning [b_t, b_{t+1}) peaks at position
b_{t+1} with expected occupancy ``min(b_{t+1}, K) * (1 - b_t/b_{t+1})``.
Under Algorithm C's cascade the whole reservoir lives in one tier at a
time, so a used tier's peak is ``min(b_{t+1}, K)`` — with the eq. 22 gate
(boundaries in [K, N)) that is exactly K, turning capacities below K into
subset-level infeasibility for the migration family.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Protocol, Tuple, runtime_checkable

import numpy as np


# ---------------------------------------------------------------------------
# Analytic occupancy / latency laws (shared by planner, verifier, meters)
# ---------------------------------------------------------------------------

def peak_occupancy(bounds, n: float, k: float, migrate: bool) -> np.ndarray:
    """(T,) expected occupancy high-water mark per tier for one stream.

    Static (no-migration) tier t over [b_t, b_{t+1}): peak at position
    b_{t+1}, ``min(b_{t+1}, K)·(1 − b_t/b_{t+1})`` (0 for empty tiers).
    Migrating streams hold the whole reservoir in one tier at a time:
    a used tier peaks at ``min(b_{t+1}, K)``; the last tier always at K.
    """
    edges = np.concatenate([[0.0], np.asarray(bounds, np.float64),
                            [float(n)]])
    hi = edges[1:]
    lo = edges[:-1]
    if migrate:
        used = (hi > lo)
        used[-1] = True
        return np.where(used, np.minimum(hi, k), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        occ = np.minimum(hi, k) * (1.0 - lo / hi)
    return np.where(hi > 0, occ, 0.0)


def peak_occupancy_arrays(bounds: np.ndarray, n: np.ndarray, k: np.ndarray,
                          migrate: np.ndarray) -> np.ndarray:
    """Vectorized ``peak_occupancy``: bounds (M, T-1) → (M, T)."""
    m = bounds.shape[0]
    edges = np.concatenate([np.zeros((m, 1)), np.asarray(bounds, np.float64),
                            np.asarray(n, np.float64)[:, None]], axis=1)
    hi, lo = edges[:, 1:], edges[:, :-1]
    kcol = np.asarray(k, np.float64)[:, None]
    used = hi > lo
    used[:, -1] = True
    occ_mig = np.where(used, np.minimum(hi, kcol), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        occ_static = np.minimum(hi, kcol) * (1.0 - lo / hi)
    occ_static = np.where(hi > 0, occ_static, 0.0)
    return np.where(np.asarray(migrate, bool)[:, None], occ_mig, occ_static)


def peak_occupancy_suffix(bounds, n, k, observed_hwm) -> np.ndarray:
    """(M, T) expected occupancy high-water mark over the *rest* of the
    window, conditioned on the observed prefix.

    The high-water mark is monotone non-decreasing, so the suffix peak is
    the elementwise max of the analytic static law at the (possibly
    re-planned) boundary vector and the occupancy already witnessed by the
    meter — a re-plan can stop a tier from growing further but can never
    un-ring the bell on a peak that already happened. Used by the online
    re-planner and the mid-window admission negotiation
    (``repro_torch.online``). ``bounds`` (M, T-1), ``observed_hwm`` (M, T).
    """
    bounds = np.atleast_2d(np.asarray(bounds, np.float64))
    m = bounds.shape[0]
    analytic = peak_occupancy_arrays(bounds, np.broadcast_to(n, (m,)),
                                     np.broadcast_to(k, (m,)),
                                     np.zeros(m, bool))
    return np.maximum(analytic, np.asarray(observed_hwm, np.float64))


def evacuation_boundaries(bounds, tier: int, n=None) -> np.ndarray:
    """Collapse ``tier`` to zero width in a boundary vector — the
    tier-outage fallback for streams without a cost model (no analytic
    suffix re-solve is possible, but residents still have to leave).

    Tier ``t`` spans ``[b[t-1], b[t])`` with ``b[-1]=0`` and an implicit
    ``+inf`` above the last boundary. An interior (or first) failed tier
    is merged into the next *colder* tier (``b[tier] ← b[tier-1]``) —
    demotion is the capacity-rich direction. The last tier has no colder
    neighbour: its boundary is pushed past the window end (``n``, or
    ``+inf`` when the stream length is unknown), promoting everything
    into the hotter neighbour. Monotonicity of the vector is preserved
    in both cases."""
    b = np.asarray(bounds, np.float64).copy()
    depth = b.shape[0]
    if tier < 0 or tier > depth:
        raise ValueError(f"tier {tier} out of range for a "
                         f"{depth + 1}-tier placement")
    if depth == 0:
        raise ValueError("single-tier placement has no surviving tier "
                         "to evacuate into")
    if tier < depth:
        b[tier] = 0.0 if tier == 0 else b[tier - 1]
    else:
        b[depth - 1] = np.inf if n is None else float(n)
    return b


def waterfill_grants(desired, budget: float) -> np.ndarray:
    """Water-filling split of a fleet-shared budget: each stream is
    granted ``min(desired_i, λ)`` with the water level λ chosen so the
    grants sum to the budget (everything granted when the desires
    already fit). Exact λ via one sort + prefix scan over the fleet —
    the single-host view (``streams.planner.waterfill`` calls it)."""
    d = np.asarray(desired, np.float64)
    if d.sum() <= budget:
        return d.copy()
    order = np.sort(d)
    m = order.shape[0]
    prefix = np.concatenate([[0.0], np.cumsum(order)])
    # smallest j where filling everyone above order[j] to order[j] overflows
    fill_at = prefix[:-1] + order * (m - np.arange(m))
    j = int(np.searchsorted(fill_at, budget, side="right"))
    lam = (budget - prefix[j]) / max(m - j, 1)
    return np.minimum(d, max(lam, 0.0))


def expected_read_latency(bounds, n: float, latencies, migrate: bool) -> float:
    """Expected per-survivor read latency at window end.

    No-migration: survivors are i.u.d. over the stream, so the expectation
    is the tier-width-weighted mean. Migration: the final read is served
    entirely from the last tier (the eq. 20 convention).
    """
    lat = np.asarray(latencies, np.float64)
    if migrate:
        return float(lat[-1])
    edges = np.concatenate([[0.0], np.asarray(bounds, np.float64),
                            [float(n)]])
    frac = np.diff(edges) / float(n)
    return float(frac @ lat)


# ---------------------------------------------------------------------------
# The constraint vocabulary
# ---------------------------------------------------------------------------

@runtime_checkable
class Constraint(Protocol):
    """A pluggable feasibility predicate over a candidate plan.

    ``feasible(cm, bounds, migrate)`` is the generic surface every
    constraint must implement (used by the brute-force verifier and by
    reconciliation); the planner additionally recognizes the concrete
    ``TierCapacity`` / ``ReadLatencySLO`` types and compiles them into
    exact vectorized masks and budget levels.
    """

    def feasible(self, cm, bounds, migrate: bool) -> bool:
        """Does the plan (boundary vector + strategy family) satisfy this
        constraint in expectation under cost model ``cm``?"""
        ...


@dataclass(frozen=True)
class TierCapacity:
    """Tier ``tier`` holds at most ``max_docs`` documents (or ``max_bytes``
    bytes, converted via the workload's document size) at any instant.

    ``shared=True`` makes the budget fleet-wide: the fleet planner splits
    it across tenants with a water-filling pass
    (``streams.planner.waterfill``) instead of granting every stream the
    full C_t.
    """

    tier: int
    max_docs: float = math.inf
    max_bytes: float | None = None
    shared: bool = False

    def docs(self, doc_gb: float) -> float:
        """The capacity in documents, taking the tighter of the doc and
        byte limits (bytes need a positive document size)."""
        cap = float(self.max_docs)
        if self.max_bytes is not None and doc_gb > 0:
            cap = min(cap, self.max_bytes / (doc_gb * 1e9))
        return cap

    def feasible(self, cm, bounds, migrate: bool) -> bool:
        if self.tier >= cm.t:
            return True
        occ = peak_occupancy(bounds, cm.workload.n_docs, cm.workload.k,
                             migrate)
        return occ[self.tier] <= self.docs(cm.workload.doc_gb) * (1 + 1e-9)


@dataclass(frozen=True)
class ReadLatencySLO:
    """The expected per-survivor read latency at window end must not
    exceed ``max_seconds`` (per-tier latencies from
    ``TierSpec.read_latency_s`` via ``NTierCostModel.read_latency``)."""

    max_seconds: float

    def feasible(self, cm, bounds, migrate: bool) -> bool:
        lat = expected_read_latency(bounds, cm.workload.n_docs,
                                    cm.read_latency, migrate)
        return lat <= self.max_seconds * (1 + 1e-9)


@dataclass(frozen=True)
class ConstraintSet:
    """An ordered bundle of constraints the planning stack consumes.

    Empty sets are free: on topologies without capacity declarations
    every planner entry point degrades bit-exactly to the unconstrained
    closed form (asserted in tests). Topology-declared capacities
    (``TierSpec.capacity_docs`` — physical properties of the hierarchy)
    always apply; an explicit ``TierCapacity`` entry *overrides* the
    declaration on its tier (``TierCapacity(t, inf)`` lifts it) — see
    :func:`effective_capacity`.
    """

    constraints: Tuple[Constraint, ...] = ()

    def __init__(self, *constraints):
        if len(constraints) == 1 and isinstance(constraints[0], (tuple, list)):
            constraints = tuple(constraints[0])
        object.__setattr__(self, "constraints", tuple(constraints))

    @classmethod
    def from_topology(cls, topo, slo: float | None = None) -> "ConstraintSet":
        cons = [TierCapacity(tier=t, max_docs=float(ts.capacity_docs))
                for t, ts in enumerate(topo.tiers)
                if ts.capacity_docs is not None]
        if slo is not None:
            cons.append(ReadLatencySLO(slo))
        return cls(*cons)

    def __iter__(self):
        return iter(self.constraints)

    def __len__(self) -> int:
        return len(self.constraints)

    @property
    def empty(self) -> bool:
        return not self.constraints

    # ---- planner-facing compilation -------------------------------------

    @property
    def capacities(self) -> Tuple[TierCapacity, ...]:
        return tuple(c for c in self.constraints
                     if isinstance(c, TierCapacity) and not c.shared)

    @property
    def shared_capacities(self) -> Tuple[TierCapacity, ...]:
        return tuple(c for c in self.constraints
                     if isinstance(c, TierCapacity) and c.shared)

    @property
    def max_read_latency(self) -> float:
        slos = [c.max_seconds for c in self.constraints
                if isinstance(c, ReadLatencySLO)]
        return min(slos) if slos else math.inf

    def capacity_array(self, t: int, doc_gb: float) -> np.ndarray:
        """(T,) per-tier document capacity (inf where unconstrained);
        shared capacities are excluded — the fleet planner splits those."""
        cap = np.full(t, np.inf)
        for c in self.capacities:
            if c.tier < t:
                cap[c.tier] = min(cap[c.tier], c.docs(doc_gb))
        return cap

    def tier_arrays(self, cm) -> Tuple[np.ndarray, np.ndarray, float]:
        """Compile this set's own constraints against one cost model:
        (cap (T,), lat (T,), slo). Topology-declared capacities are NOT
        folded in here — ``effective_capacity`` / ``shp.resolve_constraints``
        merge them with per-tier override semantics."""
        return (self.capacity_array(cm.t, cm.workload.doc_gb),
                np.asarray(cm.read_latency, np.float64),
                self.max_read_latency)

    # ---- generic feasibility (verifier / reconciliation) ----------------

    def feasible(self, cm, bounds, migrate: bool) -> bool:
        return all(c.feasible(cm, bounds, migrate) for c in self.constraints)

    def violations(self, cm, bounds, migrate: bool) -> list:
        return [c for c in self.constraints
                if not c.feasible(cm, bounds, migrate)]


def effective_capacity(cset: "ConstraintSet", cm) -> np.ndarray:
    """(T,) per-tier capacity the stack actually enforces for one model:
    topology-declared capacities (``TierSpec.capacity_docs`` — physical
    properties) always apply, and an explicit ``TierCapacity`` on tier t
    *overrides* the declaration there (``TierCapacity(t, inf)`` lifts it).
    """
    cap = cset.capacity_array(cm.t, cm.workload.doc_gb)
    declared = [c.tier for c in cset.capacities if c.tier < cm.t]
    override = np.isin(np.arange(cm.t), declared)
    return np.where(override, cap, np.minimum(cap, cm.capacity_docs))


def trivial(cap, slo) -> bool:
    """True when the compiled (cap, slo) arrays constrain nothing — the
    planner then takes the unconstrained closed-form path unchanged."""
    cap_trivial = cap is None or not np.any(np.isfinite(np.asarray(cap)))
    slo_trivial = slo is None or not np.any(np.isfinite(np.asarray(slo)))
    return cap_trivial and slo_trivial


EMPTY = ConstraintSet()
