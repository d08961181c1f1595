"""Trace-driven simulator (paper §VIII, Fig. 8), generalized to N tiers.

Replays an interestingness trace through the exact top-K reservoir and a
placement policy, accounting every transaction, byte moved, and doc-month of
rental. Used to validate the analytic model (tests assert the simulated cost
matches `core.shp` expectations on randomly-ordered traces — per tier for
N-tier topologies) and to reproduce Fig. 8's cumulative-writes comparison.

Constraint-aware additions: per-tier occupancy high-water marks (sampled at
the end of each document step) and the realized per-survivor read latency,
so capacity / SLO violations surface at reconciliation
(``SimResult.check_constraints``), not just at planning time. Tiers with a
minimum storage duration (``TierCosts.min_storage_days``) bill every stay
topped up to the minimum — the S3-IA / Glacier early-delete convention.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from .compat import TIER_A, TIER_B  # noqa: F401  (canonical home: compat)
from .costs import NTierCostModel, TwoTierCostModel
from .placement import Policy


@dataclass
class SimResult:
    n: int
    k: int
    writes_per_tier: np.ndarray  # (T,)
    reads_per_tier: np.ndarray  # (T,) final-read transactions
    migrated: int  # total migration hops across all boundaries
    evictions: int
    cum_writes: np.ndarray  # (n,) cumulative reservoir writes after doc i
    doc_months_per_tier: np.ndarray  # (T,) rental actually consumed
    survivor_ids: np.ndarray  # (k,) stream indices of final top-K
    migrated_per_boundary: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int64))  # (T-1,) hops per boundary
    occupancy_hwm_per_tier: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int64))  # (T,) peak residents
    relocated: int = 0  # residents moved by mid-window boundary re-plans
    read_latency_mean: float = 0.0  # realized per-survivor read latency (s)
    cost_writes: float = 0.0
    cost_reads: float = 0.0
    cost_storage: float = 0.0
    cost_migration: float = 0.0

    @property
    def cost_total(self) -> float:
        return self.cost_writes + self.cost_reads + self.cost_storage + self.cost_migration

    def check_constraints(self, constraint_set, cost_model) -> dict:
        """Reconciliation-time violation report against a
        ``core.constraints.ConstraintSet``: compares the *realized*
        occupancy high-water marks and read latency with the declared
        capacities / SLO. Returns per-tier boolean masks and an ``ok``
        flag."""
        from .constraints import effective_capacity
        nt = (cost_model.as_ntier()
              if isinstance(cost_model, TwoTierCostModel) else cost_model)
        cap = effective_capacity(constraint_set, nt)
        t = self.occupancy_hwm_per_tier.shape[0]
        capacity_violations = self.occupancy_hwm_per_tier > cap[:t]
        slo = constraint_set.max_read_latency
        slo_violation = bool(self.read_latency_mean > slo)
        return {
            "capacity_violations": capacity_violations,
            "slo_violation": slo_violation,
            "ok": not (capacity_violations.any() or slo_violation),
        }


CostModel = Union[TwoTierCostModel, NTierCostModel]


def simulate(scores: np.ndarray, k: int, policy: Policy,
             cost_model: Optional[CostModel] = None,
             storage_bound: bool = False,
             boundary_schedule: Optional[list] = None) -> SimResult:
    """Replay ``scores`` (interestingness trace, one doc per index).

    Exact reservoir semantics: doc i is written iff it ranks in the top-K of
    docs 0..i (ties: earlier doc wins). Eviction frees its rental. If
    ``cost_model`` is given (two-tier or N-tier), costs follow its per-doc
    conventions; with ``storage_bound`` the rental is charged as the paper's
    upper bound (K docs · full window · max-rate) instead of metered
    doc-months. Migrating policies cascade the residents of tier t-1 into
    tier t when the position crosses boundary t, each hop charged eq. 19.

    ``boundary_schedule`` replays mid-window re-planning (``repro.online``):
    a sorted list of ``(position, boundaries)`` pairs — before processing
    doc ``position`` the placement switches to the new boundary vector,
    residents whose static tier changes are relocated (each move billed
    ``cr_src + cw_dst``, counted in ``SimResult.relocated``), and later
    writes/reads follow the new boundaries. Only non-migrating policies can
    be re-scheduled (the cascade's floor semantics would be ambiguous).
    """
    scores = np.asarray(scores, dtype=np.float64)
    n = scores.shape[0]
    if not 0 < k < n:
        raise ValueError(f"require 0 < k < n, got k={k} n={n}")
    schedule = sorted(boundary_schedule) if boundary_schedule else []
    if schedule and policy.migrate_at_r:
        raise ValueError("boundary_schedule requires a non-migrating policy")

    nt = None
    if cost_model is not None:
        nt = (cost_model.as_ntier() if isinstance(cost_model, TwoTierCostModel)
              else cost_model)
    t_tiers = max(policy.n_tiers, nt.t if nt is not None else 2)
    if nt is not None and nt.t < policy.n_tiers:
        raise ValueError(f"policy places across {policy.n_tiers} tiers but "
                         f"the cost model has {nt.t}")

    # min-heap of (score, -index): root = weakest member (ties: latest doc
    # is weakest, i.e. earlier doc wins, matching topk.update's lexsort).
    heap: list[tuple[float, int]] = []
    tier_of_doc: dict[int, int] = {}
    write_index: dict[int, int] = {}
    writes = np.zeros(t_tiers, dtype=np.int64)
    reads = np.zeros(t_tiers, dtype=np.int64)
    doc_months = np.zeros(t_tiers, dtype=np.float64)
    cum_writes = np.zeros(n, dtype=np.int64)
    migrated_per_boundary = np.zeros(max(t_tiers - 1, 1), dtype=np.int64)
    mig_reads = np.zeros(t_tiers, dtype=np.int64)  # cascade hops out of tier
    mig_writes = np.zeros(t_tiers, dtype=np.int64)  # cascade hops into tier
    occupancy = np.zeros(t_tiers, dtype=np.int64)
    occupancy_hwm = np.zeros(t_tiers, dtype=np.int64)
    evictions = 0
    mig_ats = policy.migration_indices()  # one trigger per boundary, or ()
    floor = 0  # highest fired boundary: writes/residents never go below it
    wrote_so_far = 0

    wl = cost_model.workload if cost_model is not None else None
    month_per_doc_slot = (wl.window_months / n) if wl is not None else 0.0
    min_months = (nt.min_storage_months if nt is not None
                  else np.zeros(t_tiers))

    def _charge_rental(doc: int, end_i: int):
        nonlocal doc_months
        t = tier_of_doc[doc]
        # minimum-storage-duration billing: every stay is topped up
        months = (end_i - write_index[doc]) * month_per_doc_slot
        doc_months[t] += max(months, float(min_months[t]))

    def _move_doc(doc: int, dst: int, i: int) -> int:
        """Hop one resident to tier ``dst`` at position ``i`` (top up its
        rental, re-tier, bill the eq. 19 read+write, shift occupancy);
        returns the source tier so the caller can bump its own counter."""
        src = tier_of_doc[doc]
        _charge_rental(doc, i)
        tier_of_doc[doc] = dst
        write_index[doc] = i
        mig_reads[src] += 1
        mig_writes[dst] += 1
        occupancy[src] -= 1
        occupancy[dst] += 1
        return src

    relocated = 0
    sched_idx = 0
    for i in range(n):
        while sched_idx < len(schedule) and i >= schedule[sched_idx][0]:
            # mid-window re-plan: swap the placement and relocate residents
            # whose static tier changed (billed like an eq. 19 hop)
            policy = Policy(boundaries=tuple(float(b)
                                             for b in schedule[sched_idx][1]),
                            migrate_at_r=False, name=policy.name)
            sched_idx += 1
            for doc in list(tier_of_doc):
                dst = min(policy.tier_of(doc), t_tiers - 1)
                if dst != tier_of_doc[doc]:
                    _move_doc(doc, dst, i)
                    relocated += 1
        if floor < len(mig_ats) and i >= mig_ats[floor]:
            # every boundary the position has crossed fires at once:
            # residents hop *directly* to the highest crossed tier, so
            # zero-width tiers (coincident triggers) are skipped
            dst = floor
            while dst < len(mig_ats) and i >= mig_ats[dst]:
                dst += 1
            for doc in list(tier_of_doc):
                if tier_of_doc[doc] < dst:
                    _move_doc(doc, dst, i)
                    migrated_per_boundary[dst - 1] += 1
            floor = dst
        entry = (scores[i], -i)
        if len(heap) < k:
            accepted = True
        elif entry > heap[0]:
            weakest_score, neg_idx = heapq.heappop(heap)
            evict_doc = -neg_idx
            _charge_rental(evict_doc, i)
            occupancy[tier_of_doc[evict_doc]] -= 1
            del tier_of_doc[evict_doc]
            del write_index[evict_doc]
            evictions += 1
            accepted = True
        else:
            accepted = False
        if accepted:
            heapq.heappush(heap, entry)
            t = min(max(policy.tier_of(i), floor), t_tiers - 1)
            tier_of_doc[i] = t
            write_index[i] = i
            writes[t] += 1
            occupancy[t] += 1
            wrote_so_far += 1
        cum_writes[i] = wrote_so_far
        # occupancy high-water mark, sampled at the end of each doc step
        np.maximum(occupancy_hwm, occupancy, out=occupancy_hwm)

    survivors = np.array(sorted(-neg for _, neg in heap), dtype=np.int64)
    for doc in tier_of_doc:
        _charge_rental(doc, n)
    for doc in survivors:
        reads[tier_of_doc[int(doc)]] += 1

    res = SimResult(n=n, k=k, writes_per_tier=writes, reads_per_tier=reads,
                    migrated=int(migrated_per_boundary.sum()),
                    evictions=evictions, cum_writes=cum_writes,
                    doc_months_per_tier=doc_months, survivor_ids=survivors,
                    migrated_per_boundary=migrated_per_boundary,
                    occupancy_hwm_per_tier=occupancy_hwm,
                    relocated=relocated)

    if nt is not None:
        # the guard above forces t_tiers == nt.t whenever nt is given
        if reads.sum() > 0:
            res.read_latency_mean = (float(reads @ nt.read_latency)
                                     / float(reads.sum()))
        res.cost_writes = float(writes @ nt.cw)
        res.cost_reads = float(reads @ nt.cr) * wl.reads_per_window
        res.cost_migration = float(mig_reads @ nt.cr + mig_writes @ nt.cw)
        if storage_bound:
            res.cost_storage = k * nt.cs_max
        else:
            res.cost_storage = float(doc_months @ nt.storage_per_doc_month)
    return res


def random_rank_trace(n: int, rng: np.random.Generator) -> np.ndarray:
    """A trace satisfying the paper's assumption exactly: ranks are a uniform
    random permutation (scores i.u.d.)."""
    return rng.permutation(n).astype(np.float64)


def drift_weights(n: int, multipliers) -> np.ndarray:
    """(n,) per-index record-rate weights from a piecewise schedule of
    ``(start_index, multiplier)`` change points (implicit ``(0, 1.0)``
    head). Weight ``θ_i`` is the multiplier active at index i."""
    w = np.ones(n, np.float64)
    for start, mult in sorted(multipliers):
        if mult <= 0:
            raise ValueError("rate multipliers must be positive")
        w[int(start):] = float(mult)
    return w


def drifted_rank_trace(n: int, rng: np.random.Generator,
                       multipliers) -> np.ndarray:
    """A trace violating the i.u.d. assumption with *known*, piecewise
    drift: scores follow the weighted-record model (Yang 1975) — doc i
    draws ``score_i = −E_i/θ_i`` with ``E_i ~ Exp(1)``, so the probability
    that doc i beats all earlier docs is exactly ``θ_i / Σ_{j<=i} θ_j``
    and the reservoir-entry rate is ``≈ min(1, K·θ_i/Σ_{j<=i} θ_j)``
    instead of the null ``K/(i+1)`` law. ``multipliers`` is a schedule of
    ``(start_index, multiplier)`` pairs (``drift_weights``); constant
    weight 1 recovers ``random_rank_trace`` in distribution. Ground truth
    for validating ``repro_torch.online``'s drift detection and re-planning.
    """
    theta = drift_weights(n, multipliers)
    return -rng.exponential(size=n) / theta


def grn_entropy_trace(n: int, rng: np.random.Generator,
                      interesting_frac: float = 0.15) -> np.ndarray:
    """Synthetic stand-in for the paper's §VIII gene-regulatory-network
    label-entropy trace (Fig. 7): a shuffled mixture of confident
    (low-entropy) and boundary (high-entropy) classifier outputs."""
    n_hi = int(n * interesting_frac)
    p_hi = rng.beta(8, 9, size=n_hi)  # near decision boundary
    p_lo = rng.beta(0.35, 4.5, size=n - n_hi)  # confident
    p = np.clip(np.concatenate([p_hi, p_lo]), 1e-9, 1 - 1e-9)
    ent = -(p * np.log2(p) + (1 - p) * np.log2(1 - p))
    rng.shuffle(ent)
    # entropy ties are common at saturation; jitter breaks them so the trace
    # has a strict ranking (matches the paper's continuous entropies).
    return ent + rng.uniform(0, 1e-9, size=n)


def sorted_adversarial_trace(n: int, ascending: bool = True) -> np.ndarray:
    """Worst/best-case ordered trace — violates the random-order assumption;
    used to document where the analytic model breaks (DESIGN.md §9)."""
    t = np.arange(n, dtype=np.float64)
    return t if ascending else t[::-1].copy()
