"""Analytic model: the Secretary Hiring Problem adapted to tiered top-K
storage (paper §§V–VII, equations 1–22).

All expectations assume documents arrive in random order with respect to
their interestingness rank (the paper's i.u.d. assumption, validated
trace-driven in §VIII / our ``core.simulator``).

Exact forms use harmonic partial sums; ``*_approx`` forms use the paper's
logarithmic approximations (used by the case-study tables).

``plan_placement`` decides one stream; ``streams.planner.plan_fleet``
is the vectorized fleet version (same candidates, same precedence, numpy
arrays over M heterogeneous cost models).
"""
from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Literal, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constraints as constraints_mod
from . import shp_device
from .constraints import ConstraintSet, ReadLatencySLO, TierCapacity
from .costs import NTierCostModel, TwoTierCostModel

EULER_GAMMA = 0.5772156649015329


# ---------------------------------------------------------------------------
# §V — classic SHP (Algorithm A)
# ---------------------------------------------------------------------------

def classic_r_optimal(n: int) -> float:
    """Eq. 2: observe the first N/e candidates, then take the next best."""
    return n / math.e


def classic_p_best() -> float:
    """Eq. 3."""
    return 1.0 / math.e


def classic_expected_writes() -> float:
    """Eq. 4: hire (write) exactly once."""
    return 1.0


# ---------------------------------------------------------------------------
# §§VI–VII — write/read probabilities under simple overwrite (Algorithms B/C)
# ---------------------------------------------------------------------------

def p_write(i, k: int = 1):
    """Eqs. 5, 9, 10: P(doc at 0-based index ``i`` is in the top-K of the
    first i+1 docs) = min(1, K/(i+1)). Vectorized over ``i``."""
    i = np.asarray(i, dtype=np.float64)
    return np.minimum(1.0, k / (i + 1.0))


def harmonic(n) -> np.ndarray:
    """H_n for integer n >= 0 (H_0 = 0), exact via cumsum for small n,
    asymptotic for large n."""
    n = np.asarray(n, dtype=np.float64)
    small = n < 1e6
    out = np.where(
        n > 0,
        np.log(np.maximum(n, 1.0)) + EULER_GAMMA + 1.0 / (2.0 * np.maximum(n, 1.0))
        - 1.0 / (12.0 * np.maximum(n, 1.0) ** 2),
        0.0,
    )
    if np.any(small & (n > 0)):
        # exact for the small regime
        nmax = int(np.max(np.where(small, n, 0)))
        table = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, nmax + 1))])
        idx = np.clip(n.astype(np.int64), 0, nmax)
        out = np.where(small, table[idx], out)
    return out


def expected_cum_writes(i, k: int = 1) -> np.ndarray:
    """Eqs. 6, 11, 12 (exact): E[# writes among docs 0..i]
    = sum_{j<=i} min(1, K/(j+1)) = min(i+1, K) + K·(H_{i+1} − H_K)⁺."""
    i = np.asarray(i, dtype=np.float64)
    n_seen = i + 1.0
    head = np.minimum(n_seen, float(k))
    tail = k * np.maximum(harmonic(n_seen) - harmonic(float(k)), 0.0)
    return head + tail


def expected_cum_writes_approx(i, k: int = 1) -> np.ndarray:
    """Eq. 12 as printed: K + K·ln((i+1)/K)  (for i+1 >= K); eq. 7 for K=1."""
    i = np.asarray(i, dtype=np.float64)
    n_seen = i + 1.0
    return np.where(n_seen <= k, n_seen, k + k * np.log(n_seen / k))


def expected_cum_writes_batched(i, k: int, batch: int) -> np.ndarray:
    """Batched-stream generalization (beyond paper; DESIGN.md §3): when the
    reservoir merges ``batch`` docs at once, doc i is written iff it is in
    the top-K of the stream prefix ending at its *batch boundary*, so
    E[# writes ≤ i] = Σ_j min(1, K / batch_end(j)). batch=1 recovers eq. 11/12.
    """
    i = np.asarray(i, dtype=np.int64)
    imax = int(np.max(i))
    j = np.arange(imax + 1, dtype=np.float64)
    batch_end = (np.floor(j / batch) + 1.0) * batch
    per = np.minimum(1.0, k / batch_end)
    cum = np.cumsum(per)
    return cum[i]


def expected_writes_split(n: int, k: int, r: float, exact: bool = False):
    """Expected number of reservoir writes landing in tier A (stream index
    < r) vs tier B (index >= r), Algorithm C.

    Approx (paper): writes_A = K(1 + ln(r/K)), writes_B = K·ln(N/r).
    """
    r = float(min(max(r, 1.0), n))
    if exact:
        wa = float(expected_cum_writes(r - 1.0, k))
        wtot = float(expected_cum_writes(n - 1.0, k))
        return wa, wtot - wa
    if r <= k:
        wa = r
        wb = (k - r) + k * math.log(n / k) if k < n else 0.0
        # below-K regime: first K docs always write
        wb = (k - r) + k * (math.log(n) - math.log(k))
        return wa, wb
    wa = k * (1.0 + math.log(r / k))
    wb = k * (math.log(n) - math.log(r))
    return wa, wb


# ---------------------------------------------------------------------------
# §VII — expected costs of the two strategies and closed-form r*
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StrategyCost:
    strategy: str
    r_over_n: float
    total: float
    writes_a: float
    writes_b: float
    reads: float
    storage: float
    migration: float

    def breakdown(self) -> dict:
        return {
            "strategy": self.strategy, "r_over_n": self.r_over_n,
            "total": self.total, "writes_a": self.writes_a,
            "writes_b": self.writes_b, "reads": self.reads,
            "storage": self.storage, "migration": self.migration,
        }


def cost_no_migration(cm: TwoTierCostModel, r: float, exact: bool = False) -> StrategyCost:
    """Eqs. 13–16 + most-expensive-tier rental upper bound (DESIGN §1.1)."""
    wl = cm.workload
    n, k = wl.n_docs, wl.k
    r = float(np.clip(r, 1.0, n))
    wa, wb = expected_writes_split(n, k, r, exact=exact)
    writes_a, writes_b = wa * cm.cw_a, wb * cm.cw_b
    rn = r / n
    # eq. 15 (sign-consistent form): survivors are i.u.d. over the stream,
    # those with index < r live in A.
    reads = wl.reads_per_window * k * (rn * cm.cr_a + (1.0 - rn) * cm.cr_b)
    storage = k * cm.cs_max  # bound, constant in r
    total = writes_a + writes_b + reads + storage
    return StrategyCost("two_tier_no_migration", rn, total, writes_a, writes_b,
                        reads, storage, 0.0)


def cost_with_migration(cm: TwoTierCostModel, r: float, exact: bool = False) -> StrategyCost:
    """Eqs. 18–20: all docs migrate A→B at i=r; rental splits r/N; the final
    read is from B only and is *not* part of eq. 20 (paper convention)."""
    wl = cm.workload
    n, k = wl.n_docs, wl.k
    r = float(np.clip(r, 1.0, n))
    wa, wb = expected_writes_split(n, k, r, exact=exact)
    writes_a, writes_b = wa * cm.cw_a, wb * cm.cw_b
    rn = r / n
    storage = k * (rn * cm.cs_a + (1.0 - rn) * cm.cs_b)  # eq. 18
    migration = k * cm.migration_per_doc  # eq. 19, constant in r
    total = writes_a + writes_b + storage + migration  # eq. 20
    return StrategyCost("two_tier_migration", rn, total, writes_a, writes_b,
                        0.0, storage, migration)


def cost_single_tier(cm: TwoTierCostModel, tier: Literal["a", "b"],
                     exact: bool = False) -> StrategyCost:
    wl = cm.workload
    n, k = wl.n_docs, wl.k
    if exact:
        w = float(expected_cum_writes(n - 1.0, k))
    else:
        w = k * (1.0 + math.log(n / k))
    if tier == "a":
        writes, reads, storage = w * cm.cw_a, wl.reads_per_window * k * cm.cr_a, k * cm.cs_a
        return StrategyCost("all_tier_a", 1.0, writes + reads + storage,
                            writes, 0.0, reads, storage, 0.0)
    writes, reads, storage = w * cm.cw_b, wl.reads_per_window * k * cm.cr_b, k * cm.cs_b
    return StrategyCost("all_tier_b", 0.0, writes + reads + storage,
                        0.0, writes, reads, storage, 0.0)


def r_optimal_no_migration(cm: TwoTierCostModel) -> float:
    """Eq. 17: r*/N = (cw_A − cw_B) / (cr_B − cr_A). Returns r (not r/N);
    NaN if the denominator vanishes."""
    num = cm.cw_a - cm.cw_b
    den = (cm.cr_b - cm.cr_a) * cm.workload.reads_per_window
    if den == 0.0:
        return float("nan")
    return (num / den) * cm.workload.n_docs


def r_optimal_migration(cm: TwoTierCostModel) -> float:
    """Eq. 21: r*/N = (cw_A − cw_B) / (cs_B − cs_A)."""
    num = cm.cw_a - cm.cw_b
    den = cm.cs_b - cm.cs_a
    if den == 0.0:
        return float("nan")
    return (num / den) * cm.workload.n_docs


def r_is_valid(cm: TwoTierCostModel, r: float) -> bool:
    """Eq. 22: K < r* < N — plus the second-order condition the paper leaves
    implicit: d²E/dr² = −K(cw_A − cw_B)/r² > 0 requires cw_A < cw_B (tier A
    must be the write-cheap tier, else the stationary point is a *maximum*)."""
    return (math.isfinite(r) and cm.workload.k < r < cm.workload.n_docs
            and cm.cw_a < cm.cw_b)


@dataclass(frozen=True)
class PlacementPlan:
    """Outcome of the paper's decision procedure: the minimum-expected-cost
    strategy among {two-tier no-mig @ r*, two-tier mig @ r*, all-A, all-B}."""

    best: StrategyCost
    candidates: tuple
    r_no_migration: float
    r_migration: float
    n_docs: int

    @property
    def strategy(self) -> str:
        return self.best.strategy

    @property
    def r(self) -> float:
        """Absolute changeover index of the chosen strategy (N for all-A,
        0 for all-B)."""
        return self.best.r_over_n * self.n_docs

    @property
    def migrate(self) -> bool:
        return self.best.strategy == "two_tier_migration"


def plan_placement(cm, exact: bool = False,
                   constraints: Optional[ConstraintSet] = None):
    """Evaluate every strategy (respecting the eq. 22 validity gate) and pick
    the cheapest — this is the proactive decision made before the stream.

    Accepts a ``TwoTierCostModel`` (returns the paper's ``PlacementPlan``,
    unchanged) or an ``NTierCostModel`` (returns ``NTierPlacementPlan`` via
    the multi-threshold solver). A non-empty ``constraints`` routes
    two-tier models through the constrained N-tier path (returning an
    ``NTierPlacementPlan``)."""
    if isinstance(cm, NTierCostModel):
        return plan_placement_ntier(cm, constraints=constraints)
    if constraints is not None and not constraints.empty:
        if exact:
            raise ValueError("the constrained planner uses the paper's "
                             "approximate (logarithmic) forms — exact=True "
                             "is not supported with constraints")
        if any(isinstance(c, ReadLatencySLO) for c in constraints):
            raise ValueError(
                "two-tier legacy cost models carry no read latencies, so a "
                "ReadLatencySLO would be vacuous — build an NTierCostModel "
                "with TierSpec(read_latency_s=...) instead")
        return plan_placement_ntier(cm.as_ntier(), constraints=constraints)
    cands = [cost_single_tier(cm, "a", exact), cost_single_tier(cm, "b", exact)]
    r_nm = r_optimal_no_migration(cm)
    r_mg = r_optimal_migration(cm)
    if r_is_valid(cm, r_nm):
        cands.append(cost_no_migration(cm, r_nm, exact))
    if r_is_valid(cm, r_mg):
        cands.append(cost_with_migration(cm, r_mg, exact))
    best = min(cands, key=lambda s: s.total)
    return PlacementPlan(best=best, candidates=tuple(cands),
                         r_no_migration=r_nm, r_migration=r_mg,
                         n_docs=cm.workload.n_docs)


# ---------------------------------------------------------------------------
# N-tier generalization (repro.core.topology): the multi-threshold plan
# ---------------------------------------------------------------------------
#
# Doc i goes to tier t iff b_t <= i < b_{t+1} (b_0 = 0, b_T = N). Both
# strategy families have *separable* expected cost in the boundary vector:
#
#   cost(b) = sum_j f_j(b_j) + const,   f_j(b) = (cw_{j-1} - cw_j)·W(b)
#             + (lin_{j-1} - lin_j)·b [+ min(b, K)·(cr_{j-1} + cw_j)]
#
# where W(b) = E[writes among the first b docs] (eq. 12's approximation)
# and lin_t is the per-index linear coefficient (reads_per_window·K/N·cr_t
# for no-migration, K/N·cs_t for migration; the bracketed eq. 19 charge
# only for the migration family). Each f_j is piecewise {linear below K,
# a + c·ln b above K}, so on any interval its minimum sits at an endpoint,
# at the kink b = K, or at the stationary point — which is exactly the
# eq. 17/21 crossover between the two tiers the boundary separates. Under
# the monotonicity constraint b_1 <= ... <= b_{T-1}, boundaries pool into
# groups of equal value whose pooled coefficients telescope to the
# crossover between the *outer* tier pair — i.e. collapsing the degenerate
# tiers in between (the N-tier form of eq. 22's validity gate). Hence the
# finite candidate set {0, K, N} ∪ {crossover(s, t) for all tier pairs}
# contains an exact optimum, found by a tiny monotone DP per stream.
# ``brute_force_plan_ntier`` verifies this against grid search.

MAX_TIERS = 8  # 2^T candidate subsets — plenty for real hierarchies


def _w_approx(b, k):
    """Approximate cumulative write law (eq. 12 as printed): W(b) = b for
    b <= K, else K(1 + ln(b/K)). Vectorized; W(0) = 0."""
    b = np.asarray(b, np.float64)
    k = np.asarray(k, np.float64)
    safe = np.maximum(b, 1e-300)
    return np.where(b <= k, b, k * (1.0 + np.log(safe / k)))


def _cummin_with_arg(g: np.ndarray):
    """Row-wise running minimum of ``g`` (M, C) and the column index where
    each running minimum was first attained."""
    m, c = g.shape
    vals = np.empty_like(g)
    args = np.empty((m, c), np.int64)
    best = g[:, 0].copy()
    barg = np.zeros(m, np.int64)
    for j in range(c):
        upd = g[:, j] < best
        best = np.where(upd, g[:, j], best)
        barg = np.where(upd, j, barg)
        vals[:, j] = best
        args[:, j] = barg
    return vals, args


def _crossover_candidates(cw_s, lin_s, kf, lo, hi):
    """The eq. 17/21-style pairwise-crossover candidate columns shared by
    both strategy families: one stationary point per tier pair, clipped
    into the feasible boundary range."""
    out = []
    ts = cw_s.shape[1]
    for s, t in itertools.combinations(range(ts), 2):
        with np.errstate(divide="ignore", invalid="ignore"):
            b = kf * (cw_s[:, s] - cw_s[:, t]) / (lin_s[:, t] - lin_s[:, s])
        b = np.where(np.isfinite(b), b, 0.0)
        out.append(np.clip(b, lo, hi))
    return out


@dataclass
class BoundaryObjective:
    """One strategy family's separable boundary objective over a tier
    subset, plus the feasibility structure a ``ConstraintSet`` induces.

    The cost side is the same piecewise form the unconstrained planner
    minimizes: per-boundary terms ``f_j(b) = Δcw_j·W(b) + Δlin_j·b`` on a
    finite candidate grid (endpoints, the b=K kink, pairwise crossovers,
    and — when constrained — capacity corners and SLO-tight points). The
    constraint side compiles to three mechanisms the solver understands:

    * per-boundary masks (first/last-tier capacity, folded into the terms
      as +inf),
    * pairwise lower bounds ``b_{j-1} >= lb_j(b_j)`` (middle-tier
      capacity: ``min(b_j,K)(1 − b_{j-1}/b_j) <= C``),
    * a quantized latency budget (the read-path SLO, telescoped to a
      per-boundary consumption ``δ_j(b) = b·(lat_{j-1}−lat_j)/N``).

    With no constraints all three collapse and the solver reduces to the
    unconstrained monotone DP bit-exactly.
    """

    cw_s: np.ndarray  # (M, Ts)
    lin_s: np.ndarray  # (M, Ts)
    n: np.ndarray  # (M,)
    k: np.ndarray  # (M,)
    interior: bool = False  # migration family: boundaries in [K, N)
    cap_s: Optional[np.ndarray] = None  # (M, Ts) per-tier doc capacity
    lat_s: Optional[np.ndarray] = None  # (M, Ts) per-tier read latency
    slo: Optional[np.ndarray] = None  # (M,) expected-read-latency bound
    qmax: int = 48  # latency-budget quantization levels

    def __post_init__(self):
        m, ts = self.cw_s.shape
        self.m, self.ts = m, ts
        self.kf = np.asarray(self.k, np.float64)
        self.nf = np.asarray(self.n, np.float64)
        if self.cap_s is None:
            self.cap_s = np.full((m, ts), np.inf)
        if self.lat_s is None:
            self.lat_s = np.zeros((m, ts))
        if self.slo is None:
            self.slo = np.full(m, np.inf)
        self.lo = np.minimum(self.kf, self.nf) if self.interior \
            else np.zeros(m)
        self.hi = np.nextafter(self.nf, 0.0) if self.interior else self.nf

    @property
    def constrained(self) -> bool:
        return bool(np.any(np.isfinite(self.cap_s))
                    or np.any(np.isfinite(self.slo)))

    def subset_feasible(self) -> np.ndarray:
        """(M,) boundary-free feasibility of this family/subset.

        Single-tier subsets hold the whole reservoir: occupancy K and the
        final read from that tier. The migration family holds the whole
        reservoir in every used tier (boundaries gated to [K, N)), so a
        capacity below K on any used tier — or a last-tier latency above
        the SLO — kills the whole cascade subset.
        """
        kmin = np.minimum(self.kf, self.nf)
        tol = 1.0 + 1e-12
        if self.ts == 1:
            return ((kmin <= self.cap_s[:, 0] * tol)
                    & (self.lat_s[:, 0] <= self.slo * tol))
        if self.interior:
            return (np.all(self.cap_s * tol >= kmin[:, None], axis=1)
                    & (self.lat_s[:, -1] <= self.slo * tol))
        return np.ones(self.m, bool)

    def candidates(self) -> np.ndarray:
        """(M, C) sorted candidate grid: {lo, K, hi} ∪ pairwise crossovers
        ∪ (when constrained) capacity corners and SLO-tight points."""
        lo, hi, kf, nf = self.lo, self.hi, self.kf, self.nf
        cands = [lo, np.minimum(kf, nf), hi]
        cands += _crossover_candidates(self.cw_s, self.lin_s, kf, lo, hi)
        for j in range(self.ts):
            cap_j = self.cap_s[:, j]
            fin = np.isfinite(cap_j)
            if np.any(fin):
                # first-tier corner b = C_j and last-tier corner
                # b = N(1 − C_j/K) — where the capacity masks go tight
                cands.append(np.clip(np.where(fin, cap_j, 0.0), lo, hi))
                with np.errstate(invalid="ignore"):
                    tight = nf * (1.0 - cap_j / kf)
                cands.append(np.clip(np.where(fin, tight, 0.0), lo, hi))
        if np.any(np.isfinite(self.slo)) and not self.interior:
            for s, t in itertools.combinations(range(self.ts), 2):
                dl = self.lat_s[:, s] - self.lat_s[:, t]
                with np.errstate(divide="ignore", invalid="ignore"):
                    b = nf * (self.slo - self.lat_s[:, t]) / dl
                b = np.where(np.isfinite(b), b, 0.0)
                cands.append(np.clip(b, lo, hi))
        if not self.interior:
            cands += self._middle_cap_stationary(lo, hi)
        return np.sort(np.stack(cands, axis=1), axis=1)

    def _middle_cap_stationary(self, lo, hi) -> list:
        """Stationary points along an *active* middle-tier capacity curve.

        When tier ``idx`` (between boundaries idx and idx+1) binds with
        C < K, the feasible frontier is b_idx = γ·b_{idx+1} with
        γ = 1 − C/K (for b_{idx+1} > K). Substituting into the two
        boundary terms gives a 1-D objective whose stationary point is
        closed-form on each W-branch; both it and its γ-image join the
        candidate grid so the enumerated solve stays exact when the
        constraint is active between two interior boundaries.
        """
        out = []
        kf = self.kf
        for idx in range(1, self.ts - 1):
            cap_m = self.cap_s[:, idx]
            active = np.isfinite(cap_m) & (cap_m < kf)
            if not np.any(active):
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                gamma = 1.0 - cap_m / kf
            dcw_p = self.cw_s[:, idx - 1] - self.cw_s[:, idx]
            dcw_d = self.cw_s[:, idx] - self.cw_s[:, idx + 1]
            dlin_p = self.lin_s[:, idx - 1] - self.lin_s[:, idx]
            dlin_d = self.lin_s[:, idx] - self.lin_s[:, idx + 1]
            with np.errstate(divide="ignore", invalid="ignore"):
                # both boundaries on the log branch (b_prev, b_dest > K)
                b_log = -kf * (dcw_p + dcw_d) / (gamma * dlin_p + dlin_d)
                # prev on the linear branch (b_prev <= K < b_dest)
                b_mix = -kf * dcw_d / (gamma * (dcw_p + dlin_p) + dlin_d)
            for b in (b_log, b_mix):
                b = np.where(active & np.isfinite(b) & (b > 0), b, 0.0)
                out.append(np.clip(b, lo, hi))
                out.append(np.clip(b * np.where(active, gamma, 0.0), lo, hi))
        return out

    def terms(self, c: np.ndarray) -> list:
        """Per-boundary cost terms f_j on grid ``c``, with the first/last
        tier capacity masks folded in as +inf."""
        w = _w_approx(c, self.kf[:, None])
        fs = []
        for j in range(1, self.ts):
            f = ((self.cw_s[:, j - 1] - self.cw_s[:, j])[:, None] * w
                 + (self.lin_s[:, j - 1] - self.lin_s[:, j])[:, None] * c)
            fs.append(f)
        if self.constrained and not self.interior:
            tol = 1.0 + 1e-12
            first_ok = (np.minimum(c, self.kf[:, None])
                        <= self.cap_s[:, 0][:, None] * tol)
            fs[0] = np.where(first_ok, fs[0], np.inf)
            last_occ = (np.minimum(self.nf, self.kf)[:, None]
                        * (1.0 - c / self.nf[:, None]))
            last_ok = last_occ <= self.cap_s[:, -1][:, None] * tol
            fs[-1] = np.where(last_ok, fs[-1], np.inf)
        return fs

    def pair_lower_bound(self, idx: int, c: np.ndarray):
        """Lower bound on boundary ``idx`` given boundary ``idx+1`` = c —
        the middle-tier capacity ``min(c,K)(1 − b_prev/c) <= C`` solved
        for b_prev. None when tier ``idx`` is uncapped (transition is then
        the plain running minimum)."""
        if self.interior:
            return None
        cap_m = self.cap_s[:, idx]
        if not np.any(np.isfinite(cap_m)):
            return None
        with np.errstate(divide="ignore", invalid="ignore"):
            slack = 1.0 - cap_m[:, None] / np.minimum(c, self.kf[:, None])
            lb = c * np.maximum(0.0, slack)
        lb = np.where(np.isfinite(cap_m)[:, None] & (c > 0),
                      np.nan_to_num(lb, nan=0.0, posinf=0.0), 0.0)
        return lb

    def budget_deltas(self, c: np.ndarray):
        """Exact per-boundary latency consumption δ_j(b) = b·(lat_{j-1} −
        lat_j)/N (the telescoped E[read latency] minus the lat_last
        constant) and the per-stream budget Σδ_j must respect:
        rhs = slo − lat_last. None when no SLO is active (or for the
        migration family, whose final read latency is a subset constant).
        """
        if self.interior or not np.any(np.isfinite(self.slo)):
            return None
        deltas = [c * ((self.lat_s[:, j - 1] - self.lat_s[:, j])
                       / self.nf)[:, None]
                  for j in range(1, self.ts)]
        rhs = self.slo - self.lat_s[:, -1]
        return deltas, rhs

    def budget(self, c: np.ndarray):
        """Quantized read-latency budget for the resource-augmented DP
        (used for deep hierarchies, J >= 4 boundaries): per-boundary
        integer consumption levels (conservatively rounded up, so
        DP-feasible implies truly feasible) and per-stream level caps.
        None when no SLO is active or for the migration family (whose
        final read latency is a subset-level constant)."""
        exact = self.budget_deltas(c)
        if exact is None:
            return None
        deltas, rhs_exact = exact
        dmin = [d.min(axis=1) for d in deltas]
        dmax = [d.max(axis=1) for d in deltas]
        total_range = sum(dx - dn for dx, dn in zip(dmax, dmin))
        denom = max(self.qmax - (self.ts - 1), 1)
        step = total_range / denom
        levels = []
        for d, dn in zip(deltas, dmin):
            with np.errstate(divide="ignore", invalid="ignore"):
                lv = np.ceil((d - dn[:, None]) / step[:, None] - 1e-9)
            lv = np.where(step[:, None] > 0, lv, 0.0)
            levels.append(np.clip(lv, 0, self.qmax).astype(np.int64))
        rhs = rhs_exact - sum(dmin)
        with np.errstate(divide="ignore", invalid="ignore"):
            cap_lv = np.floor(rhs / step + 1e-9)
        cap_lv = np.where(step > 0, cap_lv,
                          np.where(rhs >= -1e-12, self.qmax + 1.0, -1.0))
        cap_lv = np.where(np.isfinite(self.slo), cap_lv, self.qmax + 1.0)
        cap_levels = np.clip(cap_lv, -1, self.qmax + 1).astype(np.int64)
        return levels, cap_levels, self.qmax + 2


def _solve_unconstrained(fs, c):
    """The original monotone DP: running minima left to right (first
    minimum wins), backtracked to the optimal boundary vector."""
    m = c.shape[0]
    g = fs[0]
    args = []
    for j in range(1, len(fs)):
        vals, arg = _cummin_with_arg(g)
        args.append(arg)
        g = fs[j] + vals
    rows = np.arange(m)
    best_c = np.argmin(g, axis=1)
    interior = g[rows, best_c]
    idx = [best_c]
    for arg in reversed(args):
        best_c = arg[rows, best_c]
        idx.append(best_c)
    order = np.stack(list(reversed(idx)), axis=1)  # (M, Ts-1)
    bounds = c[rows[:, None], order]
    return interior, bounds


_ENUM_MAX_STEPS = 3  # exact joint solve up to 4-tier topologies
_ENUM_CHUNK_CELLS = 20_000_000  # memory guard for the (M, G) grids


def _solve_constrained_enum(obj: BoundaryObjective, fs, c):
    """Exact constrained solve for shallow hierarchies (J <= 3 boundary
    steps, i.e. up to 4 tiers): enumerate every monotone index tuple over
    the candidate grid and mask infeasible tuples — middle-tier capacity
    as pairwise lower bounds, the read-path SLO as an exact (not
    quantized) budget sum. Because the grid contains the capacity corners
    and SLO-tight points, the feasible optimum of the continuous problem
    is on the grid up to crossover-vs-constraint interactions (verified
    against the brute-force feasible grid). Deeper hierarchies take the
    quantized resource DP instead."""
    m, ncand = c.shape
    nsteps = len(fs)
    combos = np.array(list(itertools.combinations_with_replacement(
        range(ncand), nsteps)), np.int64)  # (G, J) monotone by construction
    g = combos.shape[0]
    lbs = [obj.pair_lower_bound(idx, c) for idx in range(1, nsteps)]
    budget = obj.budget_deltas(c)
    rows = np.arange(m)
    chunk = max(1, _ENUM_CHUNK_CELLS // max(g, 1))
    interior = np.empty(m)
    order = np.empty((m, nsteps), np.int64)
    for s in range(0, m, chunk):
        sl = slice(s, min(s + chunk, m))
        total = fs[0][sl][:, combos[:, 0]]
        for j in range(1, nsteps):
            total = total + fs[j][sl][:, combos[:, j]]
        for idx in range(1, nsteps):
            lb = lbs[idx - 1]
            if lb is None:
                continue
            prev_val = c[sl][:, combos[:, idx - 1]]
            lb_dest = lb[sl][:, combos[:, idx]]
            total = np.where(prev_val >= lb_dest * (1 - 1e-12) - 1e-12,
                             total, np.inf)
        if budget is not None:
            deltas, rhs = budget
            acc = deltas[0][sl][:, combos[:, 0]]
            scale = np.abs(deltas[0][sl]).max(1)
            for j in range(1, nsteps):
                acc = acc + deltas[j][sl][:, combos[:, j]]
                scale = scale + np.abs(deltas[j][sl]).max(1)
            atol = 1e-9 * (np.abs(rhs[sl]) + scale) + 1e-15
            total = np.where(acc <= (rhs[sl] + atol)[:, None], total, np.inf)
        best = np.argmin(total, axis=1)
        interior[sl] = total[np.arange(total.shape[0]), best]
        order[sl] = combos[best]
    bounds = c[rows[:, None], order]
    return interior, bounds


def _solve_resource_dp(obj: BoundaryObjective, fs, c):
    """Resource-augmented DP over (boundary step, candidate, remaining
    latency budget): the constrained replacement for the plain monotone
    DP. Middle-tier capacities enter as pairwise transition bounds,
    the SLO as a quantized budget axis (conservatively rounded, so
    DP-feasible implies truly feasible). With no active constraints this
    reduces term-for-term to ``_solve_unconstrained`` (asserted by the
    bit-match property tests)."""
    m, ncand = c.shape
    nsteps = len(fs)
    budget = obj.budget(c)
    lbs = [obj.pair_lower_bound(idx, c) for idx in range(1, nsteps)]
    if budget is None and all(lb is None for lb in lbs):
        return _solve_unconstrained(fs, c)
    if nsteps <= _ENUM_MAX_STEPS:
        return _solve_constrained_enum(obj, fs, c)
    if budget is None:
        levels = [np.zeros((m, ncand), np.int64)] * nsteps
        cap_levels, q = np.zeros(m, np.int64), 1
    else:
        levels, cap_levels, q = budget
    rows = np.arange(m)
    crange = np.arange(ncand)
    d = np.full((m, ncand, q), np.inf)
    d[rows[:, None], crange[None, :], levels[0]] = fs[0]
    trace = []
    for step in range(1, nsteps):
        lb = lbs[step - 1]
        p = np.empty_like(d)
        amin = np.empty((m, ncand, q), np.int64)
        if lb is None:
            for qi in range(q):
                p[:, :, qi], amin[:, :, qi] = _cummin_with_arg(d[:, :, qi])
        else:
            # first candidate index satisfying b_prev >= lb(c), per (m, c)
            lb_idx = (c[:, None, :] < lb[:, :, None]).sum(-1)
            allow = ((crange[None, None, :] <= crange[None, :, None])
                     & (crange[None, None, :] >= lb_idx[:, :, None]))
            for qi in range(q):
                masked = np.where(allow, d[:, None, :, qi], np.inf)
                amin[:, :, qi] = np.argmin(masked, axis=2)
                p[:, :, qi] = np.take_along_axis(
                    masked, amin[:, :, qi][..., None], 2)[..., 0]
        trace.append(amin)
        lv = levels[step]
        q_src = np.arange(q)[None, None, :] - lv[:, :, None]
        gathered = np.take_along_axis(p, np.clip(q_src, 0, q - 1), axis=2)
        d = np.where(q_src >= 0, gathered, np.inf) + fs[step][:, :, None]
    feas = np.arange(q)[None, None, :] <= cap_levels[:, None, None]
    flat = np.where(feas, d, np.inf).reshape(m, -1)
    best = np.argmin(flat, axis=1)
    interior = flat[rows, best]
    best_c, best_q = best // q, best % q
    idx = [best_c]
    for step in range(nsteps - 1, 0, -1):
        best_q = np.clip(best_q - levels[step][rows, best_c], 0, q - 1)
        best_c = trace[step - 1][rows, best_c, best_q]
        idx.append(best_c)
    order = np.stack(list(reversed(idx)), axis=1)
    bounds = c[rows[:, None], order]
    return interior, bounds


def solve_separable_terms(obj: BoundaryObjective, fs, c):
    """Minimize a *custom* separable objective over the monotone boundary
    grid, under ``obj``'s compiled constraint structure.

    ``fs`` is a list of per-boundary term matrices (M, C) on candidate grid
    ``c`` (M, C) — any separable cost, not necessarily the planner's
    ``Δcw·W + Δlin·b`` form. ``obj`` supplies the feasibility side only:
    pairwise middle-tier capacity bounds, the quantized/exact latency
    budget, and the enum-vs-DP dispatch. This is the entry point the
    online re-planner (``repro_torch.online.replan``) uses to re-run the
    constrained boundary solve over a window *suffix*, where the cost
    terms gain drift-conditioned write laws and relocation billing that
    the a-priori objective doesn't have.

    Returns (interior_val (M,), bounds (M, Ts-1)); +inf where no feasible
    monotone vector exists.
    """
    if obj.constrained and not obj.interior:
        return _solve_resource_dp(obj, fs, c)
    return _solve_unconstrained(fs, c)


def _solve_boundaries(cw_s, lin_s, n, k, interior=False, *, cap_s=None,
                      lat_s=None, slo=None):
    """Minimize the separable boundary objective for one strategy family.

    cw_s/lin_s: (M, Ts) per-tier coefficient columns of the (sub)topology;
    n/k: (M,). With ``interior=True`` boundaries are restricted to [K, N)
    — the N-tier form of eq. 22's gate for the migration family, so the
    reservoir is full at every cascade and the last tier is always reached.
    ``cap_s``/``lat_s``/``slo`` activate the constrained solver
    (``BoundaryObjective`` + resource-augmented DP); left at None the
    original unconstrained closed form runs unchanged.

    Returns (interior_val (M,), bounds (M, Ts-1)): the sum of the boundary
    terms at the optimum (+inf where no feasible vector exists) and the
    optimal boundary vector. The caller adds the boundary-independent
    terms W(N)·cw_last + N·lin_last [+ storage bound / eq. 19 charges].
    """
    obj = BoundaryObjective(cw_s=cw_s, lin_s=lin_s, n=n, k=k,
                            interior=interior, cap_s=cap_s, lat_s=lat_s,
                            slo=slo)
    ok = obj.subset_feasible()
    if obj.ts == 1:
        return np.where(ok, 0.0, np.inf), np.zeros((obj.m, 0))
    c = obj.candidates()
    fs = obj.terms(c)
    if obj.constrained and not obj.interior:
        interior_val, bounds = _solve_resource_dp(obj, fs, c)
    else:
        interior_val, bounds = _solve_unconstrained(fs, c)
    return np.where(ok, interior_val, np.inf), bounds


@functools.lru_cache(maxsize=None)
def _tier_subsets(t: int):
    """Non-empty ordered tier subsets, singletons first then ascending by
    size — the first-minimum-wins precedence generalizing the candidate
    order of ``plan_placement``. Cached: the enumeration is pure in ``t``
    and was being recomputed on every ``plan_ntier_arrays`` call."""
    return tuple(s for size in range(1, t + 1)
                 for s in itertools.combinations(range(t), size))


@functools.lru_cache(maxsize=None)
def _cascade_subsets(t: int):
    """Tier subsets a migration cascade can traverse: at least two tiers,
    always ending in the (consumer-local) last tier — skipped middle tiers
    save their eq. 19 hop. Cached like ``_tier_subsets``."""
    return tuple(s + (t - 1,) for size in range(1, t)
                 for s in itertools.combinations(range(t - 1), size))


def _cascade_fee(cr, cw, used_cols):
    """Σ eq. 19 over consecutive used tiers: (M,) from (M, T) cost arrays
    and the ordered used-tier index list."""
    fee = np.zeros(cr.shape[0])
    for u, v in zip(used_cols, used_cols[1:]):
        fee = fee + cr[:, u] + cw[:, v]
    return fee


# Backend for the vectorized N-tier solve: "auto" routes fleets (M >=
# _DEVICE_MIN_M, T <= 4) on a CUDA device through the device solver
# (``core.shp_device`` + the ``kernels.plan_solve`` reduction) and keeps
# small or deep problems, and CPU callers, on the NumPy oracle below —
# the reference the device path is tested against.
#
# The reference's module-wide ``set_planner_backend`` is not ported: the
# port's ``plan_ntier_arrays`` takes ``backend=`` and ``device=`` on each
# call instead. A process-wide switch would change what "auto" means for
# every caller at once (the engine, the fleet planner, the re-planner),
# and the reference's tests use it only to pin one backend per
# comparison, which the port's tests do per call.
_DEVICE_MIN_M = 64


def _auto_device(device) -> torch.device:
    """``device`` when given, else the CUDA card when there is one, else
    the CPU (which keeps "auto" on the host solver)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def plan_ntier_arrays(cw, cr, cs, n, k, rpw, *, cap=None, lat=None,
                      slo=None, force_constrained=False, backend=None,
                      device=None):
    """Vectorized multi-threshold planner over M streams sharing one tier
    count T — dispatches between the device solver and the NumPy oracle
    (same contract; see ``plan_ntier_arrays_numpy`` for the model).

    ``backend`` "numpy" runs the host solver; "device" runs
    ``shp_device`` on ``device`` (the CUDA card unless the caller names
    another; raises without one, and raises ``DeviceSolverUnavailable``
    for T > 4); None or "auto" takes the device for 2 <= T <= 3
    constrained or T <= 4 unconstrained fleets of M >= 64 streams when
    the device (``device``, else the card if there is one) is CUDA, and
    the NumPy solver otherwise."""
    cw = np.asarray(cw, np.float64)
    m, t = cw.shape
    if t > MAX_TIERS:
        raise ValueError(f"topologies over {MAX_TIERS} tiers not supported")
    if backend == "jax":
        raise ValueError("the port's device planner backend is 'device', "
                         "not 'jax'")
    if backend not in (None, "auto", "numpy", "device"):
        raise ValueError(f"unknown planner backend {backend!r}")
    b = backend
    if b in (None, "auto"):
        # constrained 4-tier fleets stay on the oracle: their exact joint
        # enumeration is G ~ C^3 tuples per subset
        con = force_constrained or not constraints_mod.trivial(cap, slo)
        t_max = _ENUM_MAX_STEPS + (0 if con else 1)
        b = ("device" if 2 <= t <= t_max and m >= _DEVICE_MIN_M
             and _auto_device(device).type == "cuda" else "numpy")
    if b == "device":
        return shp_device.plan_ntier_arrays_device(
            cw, cr, cs, n, k, rpw, cap=cap, lat=lat, slo=slo,
            force_constrained=force_constrained, device=device)
    return plan_ntier_arrays_numpy(cw, cr, cs, n, k, rpw, cap=cap, lat=lat,
                                   slo=slo,
                                   force_constrained=force_constrained)


def plan_ntier_arrays_numpy(cw, cr, cs, n, k, rpw, *, cap=None, lat=None,
                            slo=None, force_constrained=False):
    """Host-side NumPy reference solver (the oracle the device path is
    verified against). cw/cr/cs: (M, T); n/k/rpw: (M,). Returns a dict
    with ``total`` (M,), ``bounds`` (M, T-1) full-topology boundary
    vectors, and ``migrate`` (M,) bool.

    No-migration family: solved per tier subset (degenerate tiers collapse
    to zero width) with the most-expensive-*used*-tier rental bound.
    Migration family: solved per cascade subset (ending at the last,
    consumer-local tier; skipped tiers save their hop) with boundaries
    gated to [K, N) (the eq. 22 gate), eq. 18-style time-split rental, and
    the constant eq. 19 charge K·(cr_u + cw_v) per traversed tier pair;
    the final read is excluded, generalizing eq. 20 — for T=2 this
    objective is exactly the paper's ``cost_with_migration``.

    Constraints enter as vectorized feasibility structure over the (M, T)
    boundary batch: ``cap`` (M, T) per-tier document capacities, ``lat``
    (M, T) per-tier read latencies, ``slo`` (M,) expected-read-latency
    bounds (all optional, +inf = unconstrained). When every entry is
    trivial the unconstrained closed form runs unchanged — bit-exactly —
    unless ``force_constrained`` routes through the resource-augmented DP
    anyway (the bit-match property tests use this). Streams with no
    feasible plan return ``total = +inf``.
    """
    cw = np.asarray(cw, np.float64)
    cr = np.asarray(cr, np.float64)
    cs = np.asarray(cs, np.float64)
    n = np.asarray(n, np.float64)
    k = np.asarray(k, np.float64)
    rpw = np.asarray(rpw, np.float64)
    m, t = cw.shape
    if t > MAX_TIERS:
        raise ValueError(f"topologies over {MAX_TIERS} tiers not supported")
    constrained = force_constrained or not constraints_mod.trivial(cap, slo)
    if constrained:
        cap = (np.full((m, t), np.inf) if cap is None
               else np.asarray(cap, np.float64))
        lat = np.zeros((m, t)) if lat is None else np.asarray(lat, np.float64)
        slo = (np.full(m, np.inf) if slo is None
               else np.asarray(slo, np.float64))
    w_n = _w_approx(n, k)
    best_total = np.full(m, np.inf)
    best_bounds = np.zeros((m, t - 1))
    best_mig = np.zeros(m, bool)
    for sub in _tier_subsets(t):
        sa = np.asarray(sub)
        lin = (rpw * k / n)[:, None] * cr[:, sa]
        kw = (dict(cap_s=cap[:, sa], lat_s=lat[:, sa], slo=slo)
              if constrained else {})
        interior, sub_bounds = _solve_boundaries(cw[:, sa], lin, n, k, **kw)
        total = (interior + w_n * cw[:, sa[-1]] + n * lin[:, -1]
                 + k * np.max(cs[:, sa], axis=1))
        edges = np.concatenate([np.zeros((m, 1)), sub_bounds, n[:, None]], 1)
        widths = np.zeros((m, t))
        widths[:, sa] = np.diff(edges, axis=1)
        full = np.cumsum(widths, axis=1)[:, :-1]
        upd = total < best_total
        best_total = np.where(upd, total, best_total)
        best_bounds = np.where(upd[:, None], full, best_bounds)
    lin_mig = (k / n)[:, None] * cs
    for sub in _cascade_subsets(t):
        sa = np.asarray(sub)
        kw = (dict(cap_s=cap[:, sa], lat_s=lat[:, sa], slo=slo)
              if constrained else {})
        interior, sub_bounds = _solve_boundaries(cw[:, sa], lin_mig[:, sa],
                                                 n, k, interior=True, **kw)
        total = (interior + w_n * cw[:, -1] + n * lin_mig[:, -1]
                 + k * _cascade_fee(cr, cw, sub))
        edges = np.concatenate([np.zeros((m, 1)), sub_bounds, n[:, None]], 1)
        widths = np.zeros((m, t))
        widths[:, sa] = np.diff(edges, axis=1)
        full = np.cumsum(widths, axis=1)[:, :-1]
        upd = total < best_total
        best_total = np.where(upd, total, best_total)
        best_bounds = np.where(upd[:, None], full, best_bounds)
        best_mig = best_mig | upd
    return {"total": best_total, "bounds": best_bounds, "migrate": best_mig}


def ntier_strategy_name(bounds, n: float, t: int, migrate: bool) -> str:
    """Histogram-friendly label: single-tier plans map onto the legacy
    ``all_tier_<letter>`` names; multi-tier plans are
    ``{two,n}_tier_{no_migration,migration}``."""
    prefix = "two_tier" if t == 2 else "ntier"
    if migrate:
        return f"{prefix}_migration"
    edges = np.concatenate([[0.0], np.asarray(bounds, np.float64), [n]])
    used = np.flatnonzero(np.diff(edges) > 0)
    if used.size == 1:
        return f"all_tier_{chr(ord('a') + int(used[0]))}"
    return f"{prefix}_no_migration"


@dataclass(frozen=True)
class NTierStrategyCost:
    """Expected-cost breakdown of one N-tier strategy at given boundaries."""

    strategy: str
    bounds_over_n: tuple
    total: float
    writes_per_tier: tuple
    reads: float
    storage: float
    migration: float

    def breakdown(self) -> dict:
        return {
            "strategy": self.strategy, "bounds_over_n": self.bounds_over_n,
            "total": self.total, "writes_per_tier": self.writes_per_tier,
            "reads": self.reads, "storage": self.storage,
            "migration": self.migration,
        }


def single_tier_bounds(cm: NTierCostModel, tier: int) -> tuple:
    """Boundary vector placing every doc in ``tier``: boundaries at or
    below it sit at 0, those above at N."""
    n = float(cm.workload.n_docs)
    return tuple(0.0 if j < tier else n for j in range(cm.t - 1))


def _edges(cm: NTierCostModel, bounds) -> np.ndarray:
    n = cm.workload.n_docs
    b = np.clip(np.asarray(bounds, np.float64), 0.0, n)
    if b.shape != (cm.t - 1,):
        raise ValueError(f"need {cm.t - 1} boundaries for T={cm.t}, "
                         f"got shape {b.shape}")
    if np.any(np.diff(b) < 0):
        raise ValueError("boundaries must be non-decreasing")
    return np.concatenate([[0.0], b, [float(n)]])


def _segment_writes(cm: NTierCostModel, edges, exact: bool) -> np.ndarray:
    k = cm.workload.k
    if exact:
        w = np.where(edges > 0, expected_cum_writes(edges - 1.0, k), 0.0)
    else:
        w = _w_approx(edges, k)
    return np.diff(w)


def cost_ntier_no_migration(cm: NTierCostModel, bounds,
                            exact: bool = False) -> NTierStrategyCost:
    """Eqs. 13–16 generalized: per-segment writes, survivor reads i.u.d.
    over the stream, most-expensive-used-tier rental bound."""
    wl = cm.workload
    edges = _edges(cm, bounds)
    w_seg = _segment_writes(cm, edges, exact)
    frac = np.diff(edges) / wl.n_docs
    writes = w_seg * cm.cw
    reads = wl.reads_per_window * wl.k * float(frac @ cm.cr)
    storage = wl.k * float(np.max(np.where(frac > 0, cm.cs, -np.inf)))
    total = float(writes.sum() + reads + storage)
    return NTierStrategyCost(
        ntier_strategy_name(edges[1:-1], wl.n_docs, cm.t, False),
        tuple(edges[1:-1] / wl.n_docs), total, tuple(writes), reads,
        storage, 0.0)


def cost_ntier_migration(cm: NTierCostModel, bounds,
                         exact: bool = False) -> NTierStrategyCost:
    """Eqs. 18–20 generalized: residents cascade directly to the next
    *used* tier when the stream crosses its boundary (zero-width tiers are
    skipped, saving their hop; the constant eq. 19 charge K·(cr_u + cw_v)
    applies per traversed pair — the planner gates boundaries to [K, N) so
    the reservoir is full at every cascade), rental follows the write
    pointer's tier time-split, and the final read — served entirely from
    the last tier — is excluded. For T=2 this is exactly
    ``cost_with_migration``."""
    wl = cm.workload
    edges = _edges(cm, bounds)
    w_seg = _segment_writes(cm, edges, exact)
    frac = np.diff(edges) / wl.n_docs
    writes = w_seg * cm.cw
    storage = wl.k * float(frac @ cm.cs)
    used = [t for t in range(cm.t) if frac[t] > 0 or t == cm.t - 1]
    migration = wl.k * float(_cascade_fee(cm.cr[None, :], cm.cw[None, :],
                                          used)[0])
    total = float(writes.sum() + storage + migration)
    return NTierStrategyCost(
        ntier_strategy_name(edges[1:-1], wl.n_docs, cm.t, True),
        tuple(edges[1:-1] / wl.n_docs), total, tuple(writes), 0.0,
        storage, migration)


@dataclass(frozen=True)
class NTierPlacementPlan:
    """Outcome of the N-tier decision procedure: the cheapest of the
    no-migration family (over all tier subsets) and the migration cascade.
    Constrained plans with no feasible boundary vector carry
    ``total = +inf`` (``feasible`` is False)."""

    best: NTierStrategyCost
    boundaries: Tuple[float, ...]
    migrate: bool
    n_docs: int
    t: int

    @property
    def strategy(self) -> str:
        return self.best.strategy

    @property
    def total(self) -> float:
        return self.best.total

    @property
    def feasible(self) -> bool:
        return math.isfinite(self.best.total)

    @property
    def r(self) -> float:
        """First changeover index (the T=2 shim)."""
        return self.boundaries[0]


def resolve_constraints(cm: NTierCostModel,
                        constraints: Optional[ConstraintSet]):
    """(cap (T,), lat (T,), slo, cset): the compiled constraint arrays for
    one model.

    Topology-declared capacities (``TierSpec.capacity_docs`` — physical
    properties of the hierarchy) always apply; an explicit
    ``ConstraintSet`` *overrides per tier*: a ``TierCapacity`` entry on
    tier t replaces the declaration there (so ``TierCapacity(t, inf)``
    explicitly lifts it), and declarations on other tiers persist. SLOs
    come only from the explicit set.
    """
    cset = constraints if constraints is not None else ConstraintSet()
    if cset.shared_capacities:
        raise ValueError(
            "shared capacities are fleet-wide budgets — plan via "
            "plan_fleet_mixed, which splits them by water-filling")
    _, lat, slo = cset.tier_arrays(cm)
    cap = constraints_mod.effective_capacity(cset, cm)
    return cap, lat, slo, cset


def _infeasible_plan(cm: NTierCostModel) -> NTierPlacementPlan:
    sc = NTierStrategyCost("infeasible", tuple([0.0] * (cm.t - 1)),
                           float("inf"), tuple([0.0] * cm.t), 0.0, 0.0, 0.0)
    return NTierPlacementPlan(best=sc, boundaries=tuple([0.0] * (cm.t - 1)),
                              migrate=False, n_docs=cm.workload.n_docs,
                              t=cm.t)


def plan_placement_ntier(cm: NTierCostModel,
                         constraints: Optional[ConstraintSet] = None
                         ) -> NTierPlacementPlan:
    """Single-stream N-tier plan (the M=1 view of ``plan_ntier_arrays``).

    With ``constraints`` (or topology-declared tier capacities) the
    resource-augmented DP plans under per-tier capacities and the
    read-path SLO; an empty/trivial ``ConstraintSet`` reproduces the
    unconstrained plan bit-identically (same code path).
    """
    wl = cm.workload
    cap, lat, slo, _ = resolve_constraints(cm, constraints)
    out = plan_ntier_arrays(cm.cw[None, :], cm.cr[None, :], cm.cs[None, :],
                            np.array([float(wl.n_docs)]),
                            np.array([float(wl.k)]),
                            np.array([wl.reads_per_window]),
                            cap=cap[None, :], lat=lat[None, :],
                            slo=np.array([slo]))
    if not np.isfinite(out["total"][0]):
        return _infeasible_plan(cm)
    bounds = tuple(float(b) for b in out["bounds"][0])
    migrate = bool(out["migrate"][0])
    fn = cost_ntier_migration if migrate else cost_ntier_no_migration
    return NTierPlacementPlan(best=fn(cm, bounds), boundaries=bounds,
                              migrate=migrate, n_docs=wl.n_docs, t=cm.t)


def plan_ntier_batch(models: Sequence[NTierCostModel], constraints=None, *,
                     device=None):
    """Vectorized plan for a batch of N-tier models sharing one T.
    ``constraints`` is a shared ``ConstraintSet`` or one per model;
    ``device`` goes to ``plan_ntier_arrays``.
    Returns (total (M,), bounds (M, T-1), migrate (M,), strategies list)."""
    t = models[0].t
    if any(m.t != t for m in models):
        raise ValueError("plan_ntier_batch needs a uniform tier count")
    cw = np.stack([m.cw for m in models])
    cr = np.stack([m.cr for m in models])
    cs = np.stack([m.cs for m in models])
    n = np.array([float(m.workload.n_docs) for m in models])
    k = np.array([float(m.workload.k) for m in models])
    rpw = np.array([m.workload.reads_per_window for m in models])
    per_model = (constraints if isinstance(constraints, (list, tuple))
                 else [constraints] * len(models))
    compiled = [resolve_constraints(m, c)
                for m, c in zip(models, per_model)]
    cap = np.stack([c[0] for c in compiled])
    lat = np.stack([c[1] for c in compiled])
    slo = np.array([c[2] for c in compiled])
    out = plan_ntier_arrays(cw, cr, cs, n, k, rpw, cap=cap, lat=lat, slo=slo,
                            device=device)
    strategies = [("infeasible" if not np.isfinite(out["total"][i])
                   else ntier_strategy_name(out["bounds"][i], n[i], t,
                                            bool(out["migrate"][i])))
                  for i in range(len(models))]
    return out["total"], out["bounds"], out["migrate"], strategies


def brute_force_plan_ntier(cm: NTierCostModel, grid: int = 48,
                           constraints: Optional[ConstraintSet] = None):
    """Ground-truth verifier: grid search over monotone boundary vectors
    for both strategy families (same objectives as the closed form).
    With ``constraints`` the grid becomes a *feasible* grid: expected
    occupancy high-water marks and read latency are evaluated per combo
    and infeasible vectors are masked to +inf (generic constraint types
    fall back to their ``feasible`` predicate row by row).
    Returns (total, bounds tuple, migrate); total is +inf when no grid
    point is feasible."""
    wl = cm.workload
    n, k, t = float(wl.n_docs), float(wl.k), cm.t
    cset = constraints if constraints is not None else ConstraintSet()
    # topology-declared capacities are enforced exactly like the planner's
    # resolve pass, so the verifier's ground truth stays comparable
    cap_r, lat_r, slo_r, _ = resolve_constraints(cm, constraints)
    active = (not cset.empty or np.any(np.isfinite(cap_r))
              or np.isfinite(slo_r))
    cap = lat = None
    slo = np.inf
    extra_vals = []
    if active:
        cap, lat, slo = cap_r, lat_r, slo_r
        for c_t in cap[np.isfinite(cap)]:
            extra_vals += [c_t, n * (1.0 - c_t / k)]
        if np.isfinite(slo):
            for s, u in itertools.combinations(range(t), 2):
                if lat[s] != lat[u]:
                    extra_vals.append(n * (slo - lat[u]) / (lat[s] - lat[u]))
    vals = np.unique(np.clip(np.concatenate([
        [0.0, min(k, n), np.nextafter(n, 0.0), n],
        np.geomspace(1.0, n, grid),
        np.asarray(extra_vals, np.float64)]), 0.0, n))
    combos = np.array(list(
        itertools.combinations_with_replacement(vals, t - 1)))
    edges = np.concatenate([np.zeros((combos.shape[0], 1)), combos,
                            np.full((combos.shape[0], 1), n)], axis=1)
    w_seg = np.diff(_w_approx(edges, k), axis=1)
    frac = np.diff(edges, axis=1) / n
    writes = w_seg @ cm.cw
    # no-migration family
    reads = wl.reads_per_window * k * (frac @ cm.cr)
    cs_used = np.max(np.where(frac > 0, cm.cs[None, :], -np.inf), axis=1)
    tot_nm = writes + reads + k * cs_used
    # migration family: zero-width tiers are skipped (saving their eq. 19
    # hop); every crossing between consecutive *used* tiers is gated to
    # [K, N) (eq. 22), and at least one crossing must happen
    g = combos.shape[0]
    kmin = min(k, n)
    used = np.concatenate([frac[:, :-1] > 0, np.ones((g, 1), bool)], axis=1)
    seen_before = np.logical_or.accumulate(used, axis=1)[:, :-1]
    crossing = used[:, 1:] & seen_before  # (G, T-1)
    gated = (combos >= kmin) & (combos < n)
    valid = np.all(~crossing | gated, axis=1) & crossing.any(axis=1)
    fee = np.zeros(g)
    prev = np.zeros(g, np.int64)
    for t_i in range(1, t):
        hop = crossing[:, t_i - 1]
        fee = fee + np.where(hop, cm.cr[prev] + cm.cw[t_i], 0.0)
        prev = np.where(used[:, t_i], t_i, prev)
    tot_mg = np.where(valid, writes + k * (frac @ cm.cs) + k * fee, np.inf)
    if cap is not None:
        tol = 1.0 + 1e-9
        gn = np.full(g, n)
        gk = np.full(g, k)
        occ_nm = constraints_mod.peak_occupancy_arrays(
            combos, gn, gk, np.zeros(g, bool))
        occ_mg = constraints_mod.peak_occupancy_arrays(
            combos, gn, gk, np.ones(g, bool))
        tot_nm = np.where(np.all(occ_nm <= cap[None, :] * tol, axis=1),
                          tot_nm, np.inf)
        tot_mg = np.where(np.all(occ_mg <= cap[None, :] * tol, axis=1),
                          tot_mg, np.inf)
        if np.isfinite(slo):
            tot_nm = np.where(frac @ lat <= slo * tol, tot_nm, np.inf)
            tot_mg = np.where(lat[-1] <= slo * tol, tot_mg, np.inf)
        generic = [c for c in cset
                   if not isinstance(c, (TierCapacity, ReadLatencySLO))]
        for con in generic:
            for i in range(g):
                if np.isfinite(tot_nm[i]) and \
                        not con.feasible(cm, combos[i], False):
                    tot_nm[i] = np.inf
                if np.isfinite(tot_mg[i]) and \
                        not con.feasible(cm, combos[i], True):
                    tot_mg[i] = np.inf
    i_nm, i_mg = int(np.argmin(tot_nm)), int(np.argmin(tot_mg))
    if not np.isfinite(tot_nm[i_nm]) and not np.isfinite(tot_mg[i_mg]):
        return float("inf"), tuple(np.zeros(t - 1)), False
    if tot_nm[i_nm] <= tot_mg[i_mg]:
        return float(tot_nm[i_nm]), tuple(combos[i_nm]), False
    return float(tot_mg[i_mg]), tuple(combos[i_mg]), True


def cost_curve(cm: TwoTierCostModel, migrate: bool, num: int = 512) -> np.ndarray:
    """Expected total cost for r swept over (K, N) — Figures 4 & 5.
    Returns array (num, 2) of [r/N, cost]."""
    wl = cm.workload
    rs = np.linspace(max(wl.k + 1, 1), wl.n_docs - 1, num)
    fn = cost_with_migration if migrate else cost_no_migration
    out = np.array([[r / wl.n_docs, fn(cm, float(r)).total] for r in rs])
    return out
