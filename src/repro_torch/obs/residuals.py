"""Model-referenced residual metrics: every fleet counter with a
closed-form law is exported as (realized, expected, normalized residual)
instead of a raw gauge.

The paper's point is that this workload class is a-priori predictable:
reservoir writes follow the batched write law
(``shp.expected_cum_writes_batched``, eq. 11/12), per-tier occupancy
follows the occupancy law (``core.constraints.peak_occupancy_arrays``),
and the final read latency is the width-weighted tier mean
(``core.constraints.expected_read_latency``). Residuals against those
laws turn monitoring into a statistically grounded early-warning
channel: a healthy stream's residuals hover near zero, and a drifted
stream's z-score crosses a concentration bound *before* operators could
tell anything from the raw counters.

``ResidualMonitor`` is the alert channel: a host-side sequential test on
the per-chunk write residual series drained from the ``FleetMeter``. It
mirrors the device detector's statistics (``online.drift``) — cumulative
deviation with a Bernstein/Bonferroni bound, plus positive/negative
excursions re-anchored at the running extremum (``dev − min_s dev_s`` is
exactly the CUSUM recursion ``max(0, S + d)``) — but is built purely
from meter counters, spends its whole ``alpha`` on the same three-way
split, and never resets until a re-plan consumes its evidence. With the
same check cadence its excursion statistic and threshold coincide with
the detector's CUSUM, so a residual alert fires at or before the CUSUM
detection, and the combined false-positive rate stays ≤ ``alpha``
(property-tested).
"""
from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------------------
# numpy forms of the laws (host-side: the monitor runs off-device)
# ---------------------------------------------------------------------------

def chunk_law_np(seen_before, seen_after, k):
    """(mean, var) of the null reservoir-entry count for a prefix
    extension a → b (numpy twin of ``online.drift.chunk_law``)."""
    a = np.asarray(seen_before, np.float64)
    b = np.asarray(seen_after, np.float64)
    kf = np.asarray(k, np.float64)
    w = b - a
    kc = np.minimum(b, kf)
    mean = np.where(b > 0, kc * w / np.maximum(b, 1.0), 0.0)
    frac = kc / np.maximum(b, 1.0)
    var = np.where(b > 1,
                   w * frac * (1.0 - frac) * (b - w)
                   / np.maximum(b - 1.0, 1.0), 0.0)
    return mean, var


def bernstein_threshold_np(var, a_const):
    """Deviation bound t with P(|Σ increments| > t) ≤ 2·exp(−a_const)."""
    var = np.asarray(var, np.float64)
    return a_const / 3.0 + np.sqrt(a_const * a_const / 9.0
                                   + 2.0 * a_const * var)


def expected_cum_writes_var_batched(i, k: int, batch: int = 1) -> np.ndarray:
    """Variance budget of the cumulative write law at position(s) ``i``:
    Σ_{j≤i} p_j(1−p_j) with p_j = min(1, K/batch_end(j)) — the
    independent-indicator budget; the true entry indicators are
    negatively associated, so concentration bounds built on it are
    conservative."""
    i = np.asarray(i, np.int64)
    if i.size == 0:
        return np.zeros(i.shape, np.float64)
    hi = int(i.max()) + 1
    j = np.arange(hi, dtype=np.float64)
    batch_end = (np.floor(j / batch) + 1.0) * batch
    p = np.minimum(1.0, float(k) / batch_end)
    cum = np.cumsum(p * (1.0 - p))
    return cum[np.minimum(i, hi - 1)]


# ---------------------------------------------------------------------------
# snapshot residuals (the exported metrics)
# ---------------------------------------------------------------------------

def write_residuals(meter, batch: int = 1) -> dict:
    """(M,) realized vs expected cumulative reservoir writes at each
    stream's current position, with the z-score under the law's variance
    budget. Streams that observed nothing report zeros."""
    expected = meter.expected_writes(batch=batch)
    realized = meter.writes.sum(1).astype(np.float64)
    var = np.zeros(meter.m, np.float64)
    seen = np.maximum(meter.observed, 1)
    for k in np.unique(meter.ks):
        sel = meter.ks == k
        var[sel] = expected_cum_writes_var_batched(seen[sel] - 1, int(k),
                                                   int(batch))
    var = np.where(meter.observed > 0, var, 0.0)
    resid = realized - expected
    z = resid / np.sqrt(np.maximum(var, 1e-12))
    z = np.where(meter.observed > 0, z, 0.0)
    return {"realized": realized, "expected": expected, "residual": resid,
            "var": var, "z": z}


def expected_tier_writes(bounds, n: int, k: int,
                         batch: int = 1) -> np.ndarray:
    """(T,) expected cumulative reservoir writes landing in each tier of
    a static placement after ``n`` docs: Λ(e_{t+1}) − Λ(e_t) with
    Λ(x) = Σ_{j≤x} min(1, K/j) (the write law, batched form when
    ``batch`` > 1) evaluated at the tier edges e = [0, ⌈b_1⌉, …, n].
    This is the occupancy law of a backend that never deletes
    (``streams.logmem`` — admitted docs stay in their write tier until
    window end), where occupancy ≡ cumulative writes."""
    from repro_torch.core import shp
    b = np.asarray(bounds, np.float64)
    edges = np.clip(np.ceil(b), 0.0, float(n))
    edges = np.concatenate([[0.0], edges, [float(n)]])
    edges = np.maximum.accumulate(edges)
    cum = np.zeros(edges.shape[0], np.float64)
    pos = edges.astype(np.int64)
    nz = pos > 0
    if nz.any():
        cum[nz] = shp.expected_cum_writes_batched(pos[nz] - 1, int(k),
                                                  int(batch))
    return np.diff(cum)


def occupancy_residuals(meter, batch: int = 1) -> dict:
    """(M, T) realized occupancy high-water marks vs the occupancy law's
    peak evaluated on the prefix seen so far (tier edges clipped to the
    current position). Cascade (migrating) streams are masked NaN — the
    law models static placements. The normalized residual is relative to
    ``max(expected, 1)`` (occupancy peaks are deterministic O(K) scale,
    not variance-budgeted sums).

    Logmem rows (``meter.logmem``) never report deletes, so their
    occupancy is cumulative writes and the reference law switches to the
    per-tier write-law deltas (``expected_tier_writes``, evaluated at
    ``batch`` — pass the ingest width for a chunk-faithful reference) —
    the residual stays near zero for an undrifted logmem tenant even
    though its storage grows past K."""
    from repro_torch.core.constraints import peak_occupancy_arrays
    bounds = meter.boundaries
    n = np.maximum(meter.observed.astype(np.float64), 1.0)
    k = meter.ks.astype(np.float64)
    expected = peak_occupancy_arrays(
        np.minimum(bounds, n[:, None]), n, k,
        np.zeros(meter.m, bool))
    logmem = np.asarray(getattr(meter, "logmem", np.zeros(meter.m, bool)),
                        bool)
    for i in np.flatnonzero(logmem & (meter.observed > 0)):
        expected[i] = expected_tier_writes(bounds[i],
                                           int(meter.observed[i]),
                                           int(meter.ks[i]), batch)
    realized = meter.occupancy_hwm.astype(np.float64)
    resid = realized - expected
    norm = resid / np.maximum(expected, 1.0)
    mask = meter.migrate | (meter.observed == 0)
    expected = np.where(mask[:, None], np.nan, expected)
    resid = np.where(mask[:, None], np.nan, resid)
    norm = np.where(mask[:, None], np.nan, norm)
    return {"realized": realized, "expected": expected, "residual": resid,
            "normalized": norm}


def latency_residuals(meter, latencies) -> dict:
    """(M,) realized mean per-survivor read latency vs the planner's
    expected read latency under the stream's boundaries. Zero reads (no
    finalize yet) reports NaN expected/residual."""
    from repro_torch.core.constraints import expected_read_latency
    lat = np.broadcast_to(np.asarray(latencies, np.float64),
                          (meter.m, meter.n_tiers))
    realized = meter.read_latency(lat)
    n = np.maximum(meter.observed.astype(np.float64), 1.0)
    expected = np.array([
        expected_read_latency(np.minimum(meter.boundaries[i], n[i]),
                              n[i], lat[i], bool(meter.migrate[i]))
        for i in range(meter.m)])
    has_reads = meter.reads.sum(1) > 0
    expected = np.where(has_reads, expected, np.nan)
    resid = realized - expected
    norm = resid / np.maximum(np.abs(expected), 1e-12)
    return {"realized": realized, "expected": expected, "residual": resid,
            "normalized": norm}


# ---------------------------------------------------------------------------
# the alert channel
# ---------------------------------------------------------------------------

class ResidualMonitor:
    """Sequential concentration-bound test on the write-residual series.

    Fed one meter drain per chunk (``update(observed, cum_writes)``);
    maintains per stream the cumulative deviation, its variance budget,
    and running-extremum anchors whose excursions replicate the CUSUM
    recursion. ``alerted`` latches; ``reset_where`` restarts a stream's
    evidence after a re-plan consumed it (mirroring the detector).

    ``law_slack`` is the (M,) fractional admit-count tolerance of an
    approximate engine backend (``streams.logmem.law_slack`` — zero for
    exact rows): each test's threshold grows by slack × the expected
    mass accumulated since its anchor, exactly mirroring the device
    detector, so an undrifted logmem fleet keeps its null FPR ≤ alpha
    while genuine drift still clears the widened bound.
    """

    def __init__(self, ks, alpha: float = 0.01, max_checks: int = 1024,
                 law_slack=None):
        ks = np.asarray(ks, np.float64)
        m = ks.shape[0]
        self.k = ks
        self.alpha = float(alpha)
        self.max_checks = int(max_checks)
        self.law_slack = (np.zeros(m, np.float64) if law_slack is None
                          else np.broadcast_to(
                              np.asarray(law_slack, np.float64), (m,)).copy())
        # same three-way alpha split as DriftConfig: whole-window gets
        # alpha/2, each excursion side alpha/4 — exponents coincide
        self.a_whole = math.log(4.0 * self.max_checks / self.alpha)
        self.a_exc = math.log(4.0 * self.max_checks / self.alpha)
        self.seen = np.zeros(m, np.float64)
        self.writes = np.zeros(m, np.float64)  # last drained cumulative
        self.dev = np.zeros(m, np.float64)
        self.var = np.zeros(m, np.float64)
        self.min_dev = np.zeros(m, np.float64)  # running min (incl. dev_0=0)
        self.var_at_min = np.zeros(m, np.float64)
        self.max_dev = np.zeros(m, np.float64)
        self.var_at_max = np.zeros(m, np.float64)
        # expected mass since the last reset and at each anchor — the
        # slack terms scale with these (zero for exact rows)
        self.exp_since = np.zeros(m, np.float64)
        self.exp_at_min = np.zeros(m, np.float64)
        self.exp_at_max = np.zeros(m, np.float64)
        self.checks = np.zeros(m, np.int64)
        self.steps = 0  # monitor updates (global chunk index)
        self.alerted = np.zeros(m, bool)
        self.first_alert_step = np.full(m, -1, np.int64)
        self.first_alert_seen = np.full(m, -1, np.int64)
        # whole-run law totals (never reset): the snapshot's chunk-aware
        # expectation — the batched write law evaluated at the actual
        # ingest chunking, which the meter alone cannot reconstruct
        self.exp_total = np.zeros(m, np.float64)
        self.var_total = np.zeros(m, np.float64)

    @property
    def m(self) -> int:
        return self.k.shape[0]

    def _extra(self):
        """Decaying budget extension past max_checks (detector twin)."""
        over = np.maximum(self.checks.astype(np.float64) / self.max_checks,
                          1.0)
        return 2.0 * np.log(over)

    def update(self, observed, cum_writes) -> np.ndarray:
        """Fold one chunk boundary's meter drain: ``observed`` (M,) docs
        seen, ``cum_writes`` (M,) cumulative reservoir writes. Returns
        the (M,) newly-alerted mask."""
        b = np.asarray(observed, np.float64)
        w = np.asarray(cum_writes, np.float64)
        active = b > self.seen
        mean, var_c = chunk_law_np(self.seen, b, self.k)
        d = np.where(active, (w - self.writes) - mean, 0.0)
        var_c = np.where(active, var_c, 0.0)
        self.dev += d
        self.var += var_c
        exp_c = np.where(active, mean, 0.0)
        self.exp_total += exp_c
        self.exp_since += exp_c
        self.var_total += var_c
        self.checks += active
        self.steps += 1
        extra = self._extra()
        # excursion = deviation re-anchored at its running extremum: the
        # CUSUM recursion, with the variance spent since the anchor;
        # law_slack widens each threshold by the expected mass since
        # that anchor (approximate-backend tolerance, zero when exact)
        whole = np.abs(self.dev) > bernstein_threshold_np(
            self.var, self.a_whole + extra) \
            + self.law_slack * self.exp_since
        pos = (self.dev - self.min_dev) > bernstein_threshold_np(
            self.var - self.var_at_min, self.a_exc + extra) \
            + self.law_slack * (self.exp_since - self.exp_at_min)
        neg = (self.max_dev - self.dev) > bernstein_threshold_np(
            self.var - self.var_at_max, self.a_exc + extra) \
            + self.law_slack * (self.exp_since - self.exp_at_max)
        hit = active & (whole | pos | neg)
        newly = hit & ~self.alerted
        # first alert only: evidence resets (``reset_where``) let a stream
        # re-alert, but the detection latency record keeps the earliest
        first = newly & (self.first_alert_step < 0)
        self.first_alert_step[first] = self.steps
        self.first_alert_seen[first] = b[first].astype(np.int64)
        self.alerted |= hit
        # advance the anchors after testing (dev_0 = 0 is a valid anchor)
        lower = self.dev < self.min_dev
        self.min_dev = np.where(lower, self.dev, self.min_dev)
        self.var_at_min = np.where(lower, self.var, self.var_at_min)
        self.exp_at_min = np.where(lower, self.exp_since, self.exp_at_min)
        higher = self.dev > self.max_dev
        self.max_dev = np.where(higher, self.dev, self.max_dev)
        self.var_at_max = np.where(higher, self.var, self.var_at_max)
        self.exp_at_max = np.where(higher, self.exp_since, self.exp_at_max)
        self.seen = np.where(active, b, self.seen)
        self.writes = np.where(active, w, self.writes)
        return newly

    def scores(self) -> np.ndarray:
        """(M,) max test statistic over its threshold (≥ 1 ⇒ alert)."""
        extra = self._extra()
        whole = np.abs(self.dev) / np.maximum(
            bernstein_threshold_np(self.var, self.a_whole + extra)
            + self.law_slack * self.exp_since, 1e-9)
        pos = (self.dev - self.min_dev) / np.maximum(
            bernstein_threshold_np(self.var - self.var_at_min,
                                   self.a_exc + extra)
            + self.law_slack * (self.exp_since - self.exp_at_min), 1e-9)
        neg = (self.max_dev - self.dev) / np.maximum(
            bernstein_threshold_np(self.var - self.var_at_max,
                                   self.a_exc + extra)
            + self.law_slack * (self.exp_since - self.exp_at_max), 1e-9)
        return np.maximum(whole, np.maximum(pos, neg))

    def reset_where(self, mask) -> None:
        """Restart the masked streams' evidence (after a re-plan);
        ``seen``/``writes`` baselines are preserved."""
        mask = np.asarray(mask, bool)
        for name in ("dev", "var", "min_dev", "var_at_min", "max_dev",
                     "var_at_max", "exp_since", "exp_at_min", "exp_at_max"):
            arr = getattr(self, name)
            arr[mask] = 0.0
        self.checks[mask] = 0
        self.alerted[mask] = False

    # ---- crash-consistent checkpointing ---------------------------------

    _STATE_ARRAYS = (
        "seen", "writes", "dev", "var", "min_dev", "var_at_min",
        "max_dev", "var_at_max", "exp_since", "exp_at_min", "exp_at_max",
        "checks", "alerted", "first_alert_step", "first_alert_seen",
        "exp_total", "var_total")

    def state_dict(self) -> dict:
        """All mutable state as fresh numpy copies (safe to hand to an
        async checkpoint writer while the engine keeps updating)."""
        out = {name: getattr(self, name).copy()
               for name in self._STATE_ARRAYS}
        out["steps"] = np.int64(self.steps)
        return out

    def load_state(self, state: dict) -> None:
        for name in self._STATE_ARRAYS:
            ref = getattr(self, name)
            arr = np.asarray(state[name]).astype(ref.dtype).reshape(
                ref.shape)
            setattr(self, name, arr.copy())
        self.steps = int(state["steps"])

    def write_z(self) -> dict:
        """(M,) whole-run realized vs chunk-law expected cumulative
        writes with the z-score — the snapshot's exported residual
        (chunk-aware, unlike the batch-agnostic ``write_residuals``).
        Approximate-backend rows fold their systematic tolerance
        (law_slack × expected)² into the variance so their z stays O(1)
        when the backend tracks the law within its guarantee."""
        resid = self.writes - self.exp_total
        var_eff = self.var_total + (self.law_slack * self.exp_total) ** 2
        z = resid / np.sqrt(np.maximum(var_eff, 1e-12))
        z = np.where(self.seen > 0, z, 0.0)
        return {"realized": self.writes.copy(),
                "expected": self.exp_total.copy(), "residual": resid,
                "var": var_eff, "z": z}

    def snapshot(self) -> dict:
        sc = self.scores()
        return {"alerted": int(self.alerted.sum()),
                "max_score": float(sc.max()) if sc.size else 0.0,
                "checks": int(self.checks.max()) if self.m else 0,
                "steps": self.steps}
