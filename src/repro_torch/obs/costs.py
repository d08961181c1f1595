"""Live cost attribution: device-resident per-stream cost ledgers,
closed-form expected-cost trajectories, regret, and budget burn alerts.

The paper's objective *is* cost — expected write + storage + read +
migration spend under the SHP write/lifetime laws — so the cost layer
follows the same model-referenced discipline as ``obs.residuals``:
realized spend is compared to what the planner's closed forms promised,
and alerts fire on statistically significant deviation, not thresholds
on raw gauges.

Three pieces:

* ``CostState`` — a small per-bucket set of tensors carried through
  ``streams.engine.step`` (``obs.metrics``'s discipline: every update is a
  few tensor reductions over values the step already materializes,
  queued on the engine's device, with no read back to the host —
  drained only at ``snapshot``). It counts integer per-(stream, tier)
  transactions: writes, deletes, and ``resident_steps`` (the storage
  integral — post-step occupancy × docs ingested, a doc-step rental
  meter that at chunk width 1 equals the simulator's per-doc doc-month
  accounting exactly). Counts stay int32 on the device; pricing happens
  on the host in float64 at drain time, so identical integers priced
  through identical dot products give bit-equal cost components. Drain
  and rebase before a window approaches 2^31 doc-steps.

* Closed-form **expected-cost trajectory** — the prefix integral of the
  write law (``chunk_law_np`` split across tier widths) plus the
  survivor law's expected occupancy ``E[occ_t(s)] = width_t(s) ·
  min(1, K/s)``, priced by the stream's stacked ``NTierCostModel``
  cw/cs vectors. Logmem tenants (no deletions — occupancy ≡ cumulative
  writes) switch the storage law to the chunk-aware expected per-tier
  writes, and every test threshold is widened by ``law_slack`` × the
  expected cost mass, mirroring the drift detector.

* ``CostMonitor`` — the alert channel: a host-side sequential test on
  the *cost-weighted* write residual (Bernstein bound with per-stream
  increment cap ``max_t cw_t``; whole-window + CUSUM-equivalent
  positive/negative excursions, exactly ``ResidualMonitor``'s state
  machine), plus SRE-style multi-window **budget burn-rate** alerts:
  realized spend over a (long, short) chunk-window pair exceeding
  ``threshold × budget_factor ×`` the planned spend on *both* windows,
  gated by the same Bernstein margin so the combined null
  false-positive rate stays ≤ alpha (property-tested). Alerts can union
  into the re-plan trigger exactly like ``residual_trigger``.

Device-ledger scope: tiers are attributed by each doc's *static*
position tier against the stream's current boundary vector (the leaf is
updated by the host after a re-plan — no recompiles). Migration-cascade
streams lift residents above the static tier; their hop accounting
stays in the host ``FleetMeter`` (``mig_reads``/``mig_writes``), and the
reconciliation guarantees below are stated for non-cascade streams.

The port of the reference's ``obs.costs``: the device ledger in torch,
the host half a NumPy copy.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod

from .residuals import chunk_law_np


# ---------------------------------------------------------------------------
# device ledger
# ---------------------------------------------------------------------------

class CostState(NamedTuple):
    """Per-bucket device cost ledger (rows = the bucket's streams).

    ``bounds`` holds the *ceiled* boundary vector in float32, +inf
    padded: doc ids are integers, so ``id >= ceil(b)`` ⟺ ``id >= b``, and
    ceiled edges are exactly representable in float32 (up to 2^24) — the
    device tier attribution is bit-equal to the host meter's float64
    comparison."""

    bounds: torch.Tensor  # (Mb, B) f32 — ceiled boundaries, +inf padded
    writes: torch.Tensor  # (Mb, T) i32 — admits priced cw at the write tier
    deletes: torch.Tensor  # (Mb, T) i32 — evictions per current static tier
    resident_steps: torch.Tensor  # (Mb, T) i32 — Σ occupancy × chunk docs


def init_bucket(m: int, boundaries: np.ndarray, n_tiers: int,
                device=None) -> CostState:
    """Fresh ledger for one bucket of ``m`` streams on ``device`` (the
    CUDA card unless given): ``boundaries`` is the meter's (m, B)
    float64 block for the bucket's rows."""
    dev = device_mod.resolve(device)
    b = np.asarray(boundaries, np.float64)
    bounds = np.full((m, b.shape[1]), np.inf, np.float32)
    bounds[: b.shape[0]] = np.ceil(b).astype(np.float32)

    def zeros():
        return torch.zeros((m, n_tiers), dtype=torch.int32, device=dev)

    return CostState(bounds=torch.from_numpy(bounds).to(dev),
                     writes=zeros(), deletes=zeros(),
                     resident_steps=zeros())


def set_bucket_bounds(cs: CostState, row: int, bounds_row) -> CostState:
    """Host-side boundary swap after a re-plan: one row of the bounds
    tensor is replaced (ceiled, +inf padded); its shape is unchanged."""
    b = np.full(cs.bounds.shape[1], np.inf, np.float32)
    vec = np.asarray(bounds_row, np.float64).reshape(-1)
    b[: vec.shape[0]] = np.ceil(vec).astype(np.float32)
    bounds = cs.bounds.clone()
    bounds[row] = torch.from_numpy(b).to(bounds.device)
    return cs._replace(bounds=bounds)


def _tier_of(ids, bounds):
    """(Mb, W) static tier = number of boundaries <= id (ids are integer
    positions compared in float32; bounds are ceiled, see
    ``CostState``)."""
    return (ids[:, :, None].to(torch.float32)
            >= bounds[:, None, :]).sum(-1, dtype=torch.int32)


def _per_tier(tiers, mask, n_tiers: int):
    """(Mb, T) int32 masked per-tier counts (T masked reductions)."""
    return torch.stack([(mask & (tiers == t)).sum(1, dtype=torch.int32)
                        for t in range(n_tiers)], dim=1)


def accumulate_exact(cs: CostState, batch_ids, wrote, evicted_ids,
                     state_ids) -> CostState:
    """Fold one exact-backend bucket step into the ledger. Occupancy is
    recomputed from the post-step reservoir ids, so ``resident_steps``
    accrues occupancy × the chunk's live docs — the right-Riemann storage
    integral, exact vs the simulator's per-doc rental at chunk width
    1."""
    t = cs.writes.shape[1]
    live = batch_ids >= 0
    dw = _per_tier(_tier_of(batch_ids, cs.bounds), wrote & live, t)
    dd = _per_tier(_tier_of(evicted_ids, cs.bounds), evicted_ids >= 0, t)
    occ = _per_tier(_tier_of(state_ids, cs.bounds), state_ids >= 0, t)
    docs = live.sum(1, dtype=torch.int32)
    return cs._replace(writes=cs.writes + dw, deletes=cs.deletes + dd,
                       resident_steps=cs.resident_steps
                       + occ * docs[:, None])


def accumulate_logmem(cs: CostState, batch_ids, wrote) -> CostState:
    """Logmem-bucket step: no ids stored and nothing deletes, so
    occupancy ≡ cumulative writes per tier and the storage integral
    accrues the post-step cumulative write counts."""
    t = cs.writes.shape[1]
    live = batch_ids >= 0
    dw = _per_tier(_tier_of(batch_ids, cs.bounds), wrote & live, t)
    writes = cs.writes + dw
    docs = live.sum(1, dtype=torch.int32)
    return cs._replace(writes=writes,
                       resident_steps=cs.resident_steps
                       + writes * docs[:, None])


# ---------------------------------------------------------------------------
# host pricing (f64, at drain time only)
# ---------------------------------------------------------------------------

def stream_pricing(engine) -> dict:
    """Stacked per-stream pricing vectors from the fleet's cost models:
    ``cw``/``cr`` (M, T) per-doc write/read cost per tier,
    ``step_rate`` (M, T) rental per doc-step (storage rate × the
    stream's window-months-per-doc slot), ``reads_per_window`` (M,) and
    ``n_docs`` (M,). Streams without a cost model price to zero — their
    ledgers still count, but every cost channel is inert."""
    from repro_torch.core.costs import TwoTierCostModel
    m, t = engine.m, engine.meter.n_tiers
    cw = np.zeros((m, t), np.float64)
    cr = np.zeros((m, t), np.float64)
    step_rate = np.zeros((m, t), np.float64)
    rpw = np.zeros(m, np.float64)
    n_docs = np.zeros(m, np.int64)
    has_model = np.zeros(m, bool)
    for row in range(m):
        cm = engine._model_of_row.get(row)
        if cm is None:
            continue
        nt = cm.as_ntier() if isinstance(cm, TwoTierCostModel) else cm
        d = min(nt.t, t)
        cw[row, :d] = nt.cw[:d]
        cr[row, :d] = nt.cr[:d]
        wl = nt.workload
        slot = wl.window_months / wl.n_docs
        step_rate[row, :d] = nt.storage_per_doc_month[:d] * slot
        rpw[row] = wl.reads_per_window
        n_docs[row] = wl.n_docs
        has_model[row] = True
    return {"cw": cw, "cr": cr, "step_rate": step_rate,
            "reads_per_window": rpw, "n_docs": n_docs,
            "has_model": has_model}


def device_counts(engine) -> dict:
    """Drain the per-bucket device ledgers into global (M, T) int64
    arrays (the only sync point — one transfer per leaf per bucket, and
    per shard under a fleet mesh, whose padding rows are cut)."""
    t, m = engine.meter.n_tiers, engine.m
    out = {name: np.zeros((m, t), np.int64)
           for name in ("writes", "deletes", "resident_steps")}
    for bi, cs in enumerate(engine._cost_states):
        rows = engine._global_rows[bi]
        for name in out:
            out[name][rows] = engine._host(
                bi, cs, lambda c, name=name: getattr(c, name))
    return out


def realized_costs(engine) -> dict:
    """Price the device ledger + the meter's host-side hop counters into
    per-stream realized cost components (the ``SimResult`` convention:
    writes @ cw, final reads @ cr × reads_per_window, doc-steps × the
    per-step rental rate, migration/relocation hops priced
    ``cr_src + cw_dst``)."""
    p = engine._pricing
    dev = device_counts(engine)
    meter = engine.meter
    writes = (dev["writes"] * p["cw"]).sum(1)
    reads = (meter.reads * p["cr"]).sum(1) * p["reads_per_window"]
    storage = (dev["resident_steps"] * p["step_rate"]).sum(1)
    migration = ((meter.mig_reads + meter.reloc_reads) * p["cr"]).sum(1) \
        + ((meter.mig_writes + meter.reloc_writes) * p["cw"]).sum(1)
    return {"writes": writes, "reads": reads, "storage": storage,
            "migration": migration,
            "total": writes + reads + storage + migration,
            "device": dev}


def cost_summary(engine) -> dict:
    """Per-stream realized / planned / regret arrays (the regret meter).

    ``planned`` is the monitor's chunk-aware expected write + storage
    trajectory at the current position, plus the expected final-read
    cost once the stream's reads are metered (finalize). ``regret`` is
    realized − planned; relocation/migration bills count against
    realized only (the plan assumes no mid-window moves)."""
    real = realized_costs(engine)
    mon = engine._cost_monitor
    p = engine._pricing
    meter = engine.meter
    planned = mon.planned_total.copy()
    finalized = meter.reads.sum(1) > 0
    if finalized.any():
        n = np.maximum(p["n_docs"].astype(np.float64), 1.0)
        widths = interval_tier_widths(meter.boundaries,
                                      np.zeros(engine.m), n)
        exp_reads = widths / n[:, None] * meter.ks[:, None]
        planned = planned + np.where(
            finalized,
            (exp_reads * p["cr"]).sum(1) * p["reads_per_window"], 0.0)
    return {**real, "planned": planned,
            "regret": real["total"] - planned}


def snapshot(engine) -> dict:
    """The engine's ``obs_snapshot`` cost section: fleet-level priced
    components, the regret meter, the raw device counter totals, and the
    alert channel state. Deterministic scalars only."""
    summ = cost_summary(engine)
    dev = summ["device"]
    out = {
        "realized": {k: float(summ[k].sum())
                     for k in ("writes", "reads", "storage", "migration",
                               "total")},
        "planned_total": float(summ["planned"].sum()),
        "regret": {"fleet": float(summ["regret"].sum()),
                   "max": float(summ["regret"].max()) if engine.m else 0.0},
        "device": {name: int(arr.sum()) for name, arr in dev.items()},
    }
    if engine._cost_monitor is not None:
        out["alerts"] = engine._cost_monitor.snapshot()
    return out


# ---------------------------------------------------------------------------
# the closed-form expected-cost laws
# ---------------------------------------------------------------------------

def interval_tier_widths(bounds, a, b) -> np.ndarray:
    """(M, T) integer counts of doc ids in [a, b) falling in each static
    tier of the (M, B) boundary vectors (+inf padded): tier edges are
    the ceiled boundaries, so this is exact for integer positions."""
    bounds = np.asarray(bounds, np.float64)
    m = bounds.shape[0]
    a = np.broadcast_to(np.asarray(a, np.float64), (m,))
    b = np.broadcast_to(np.asarray(b, np.float64), (m,))
    e = np.ceil(bounds)
    lo = np.concatenate([np.zeros((m, 1)), e], axis=1)
    hi = np.concatenate([e, np.full((m, 1), np.inf)], axis=1)
    return np.clip(np.minimum(hi, b[:, None]) - np.maximum(lo, a[:, None]),
                   0.0, None)


def expected_occupancy(bounds, k, s) -> np.ndarray:
    """(M, T) expected exact-backend occupancy after ``s`` docs: every
    one of the first s docs survives w.p. min(1, K/s) (uniform ranks),
    so E[occ_t(s)] = width_t(0, s) · min(1, K/s) — the survivor law the
    planner's storage integral is built on."""
    k = np.asarray(k, np.float64)
    s = np.asarray(s, np.float64)
    frac = np.minimum(1.0, k / np.maximum(s, 1.0))
    return interval_tier_widths(bounds, 0.0, s) * frac[:, None]


def bernstein_threshold_weighted(var, a_const, cmax) -> np.ndarray:
    """Deviation bound for sums of increments bounded by ``cmax`` (the
    per-stream max per-doc write cost): the unit-bounded Bernstein bound
    of ``residuals.bernstein_threshold_np`` scaled to the cap."""
    var = np.asarray(var, np.float64)
    cmax = np.asarray(cmax, np.float64)
    ac = a_const * cmax
    return ac / 3.0 + np.sqrt(ac * ac / 9.0 + 2.0 * a_const * var)


def expected_cost_trajectory(bounds, n: int, k: int, cw, step_rate,
                             chunk: int = 1, logmem: bool = False
                             ) -> np.ndarray:
    """(C,) planned cumulative write + storage cost for ONE stream after
    each width-``chunk`` ingest step — the closed-form trajectory the
    monitor tests realized spend against (final-read cost lands at
    finalize and is excluded here). ``logmem`` switches the storage law
    to cumulative expected writes (nothing deletes)."""
    bounds = np.asarray(bounds, np.float64).reshape(1, -1)
    cw = np.asarray(cw, np.float64)
    step_rate = np.asarray(step_rate, np.float64)
    edges = np.arange(0, n + chunk, chunk, dtype=np.float64)
    edges[-1] = min(edges[-1], float(n))
    exp_writes = np.zeros(bounds.shape[1] + 1, np.float64)
    total = 0.0
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        mean, _ = chunk_law_np(np.array([a]), np.array([b]), np.array([k]))
        w = interval_tier_widths(bounds, a, b)[0]
        frac = w / max(b - a, 1.0)
        exp_writes = exp_writes + float(mean[0]) * frac
        occ = (exp_writes if logmem
               else expected_occupancy(bounds, [k], [b])[0])
        total += float(mean[0]) * float(frac @ cw) \
            + float(occ @ step_rate) * (b - a)
        out.append(total)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# the alert channel: cost residuals + budget burn rate
# ---------------------------------------------------------------------------

class CostMonitor:
    """Sequential concentration-bound test on the cost-weighted write
    residual series, plus multi-window budget burn-rate alerts.

    Fed one meter drain per chunk (``update(observed, writes_per_tier,
    doc_steps)`` — cumulative counters, like ``ResidualMonitor``).
    Maintains per stream the cost-weighted write deviation with
    ``ResidualMonitor``'s exact anchor machinery (whole-window +
    positive/negative excursions ≡ CUSUM), with Bernstein thresholds
    scaled to the per-stream increment cap ``max_t cw_t`` and widened by
    ``law_slack`` × the expected cost mass for approximate backends.

    The burn channel keeps a rolling per-chunk spend history; a
    ``(long, short, threshold)`` window pair alerts when realized spend
    exceeds ``threshold × budget_factor × planned`` on BOTH windows AND
    the window's write-cost deviation clears its own Bernstein gate —
    the gate keeps the null false-positive rate of the whole channel
    ≤ alpha (the ratio test alone would fire on planned≈0 noise).

    The total alpha is split uniformly across the 3 + n_pairs channels
    (each threshold exponent ``log(2 · channels · max_checks / alpha)``).
    """

    def __init__(self, ks, boundaries, cw, step_rate, *,
                 alpha: float = 0.01, max_checks: int = 1024,
                 law_slack=None, logmem=None, budget_factor: float = 1.2,
                 burn_windows: Tuple = ((8, 2, 1.5), (32, 8, 1.2))):
        self.k = np.asarray(ks, np.float64)
        m = self.k.shape[0]
        self.bounds = np.array(boundaries, np.float64)
        t = self.bounds.shape[1] + 1
        self.cw = np.asarray(cw, np.float64).reshape(m, t)
        self.step_rate = np.asarray(step_rate, np.float64).reshape(m, t)
        self.cmax = self.cw.max(axis=1)
        self.alpha = float(alpha)
        self.max_checks = int(max_checks)
        self.law_slack = (np.zeros(m, np.float64) if law_slack is None
                          else np.broadcast_to(
                              np.asarray(law_slack, np.float64), (m,)).copy())
        self.logmem = (np.zeros(m, bool) if logmem is None
                       else np.asarray(logmem, bool))
        self.budget_factor = float(budget_factor)
        self.burn_windows = tuple((int(l), int(s), float(r))
                                  for l, s, r in burn_windows)
        channels = 3 + len(self.burn_windows)
        self.a_const = math.log(2.0 * channels * self.max_checks
                                / self.alpha)
        self._hist_len = max([l for l, _, _ in self.burn_windows],
                             default=0)
        # sequential-test state (ResidualMonitor's machine, cost units)
        self.seen = np.zeros(m, np.float64)
        self.writes_pt = np.zeros((m, t), np.float64)
        self.doc_steps_pt = np.zeros((m, t), np.float64)
        self.exp_writes_pt = np.zeros((m, t), np.float64)
        self.dev = np.zeros(m, np.float64)
        self.var = np.zeros(m, np.float64)
        self.min_dev = np.zeros(m, np.float64)
        self.var_at_min = np.zeros(m, np.float64)
        self.max_dev = np.zeros(m, np.float64)
        self.var_at_max = np.zeros(m, np.float64)
        self.exp_since = np.zeros(m, np.float64)
        self.exp_at_min = np.zeros(m, np.float64)
        self.exp_at_max = np.zeros(m, np.float64)
        self.checks = np.zeros(m, np.int64)
        self.steps = 0
        self.alerted = np.zeros(m, bool)
        self.burn_alerted = np.zeros(m, bool)
        self.first_alert_step = np.full(m, -1, np.int64)
        self.first_alert_seen = np.full(m, -1, np.int64)
        self.first_burn_seen = np.full(m, -1, np.int64)
        # tier-outage grace: burn alerts are gated off per stream until
        # this monitor step — a forced evacuation's relocation spend is
        # not tenant overspend
        self.burn_suppressed_until = np.zeros(m, np.int64)
        # whole-run totals (never reset): the regret meter's plan side
        self.realized_total = np.zeros(m, np.float64)
        self.planned_total = np.zeros(m, np.float64)
        self.realized_wcost = np.zeros(m, np.float64)
        self.exp_wcost_total = np.zeros(m, np.float64)
        self.var_total = np.zeros(m, np.float64)
        # rolling per-chunk spend history for the burn windows
        self._hist: List[Tuple[np.ndarray, ...]] = []

    @property
    def m(self) -> int:
        return self.k.shape[0]

    def _extra(self):
        over = np.maximum(self.checks.astype(np.float64) / self.max_checks,
                          1.0)
        return 2.0 * np.log(over)

    def set_bounds(self, row: int, new_bounds) -> None:
        """Swap one stream's boundary vector after an applied re-plan:
        the planned trajectory follows the new placement from the next
        chunk on (residents were relocated, so the survivor law's
        uniform-position argument still prices expected occupancy)."""
        vec = np.asarray(new_bounds, np.float64).reshape(-1)
        self.bounds[row, :] = np.inf
        self.bounds[row, : vec.shape[0]] = vec
        # re-split the accumulated expected writes across the new tiers:
        # the total expected mass is placement-independent, only its
        # tier attribution moves (matching the relocated residents)
        tot = self.exp_writes_pt[row].sum()
        seen = max(self.seen[row], 1.0)
        w = interval_tier_widths(self.bounds[row: row + 1], 0.0, seen)[0]
        self.exp_writes_pt[row] = tot * w / max(w.sum(), 1.0)

    def update(self, observed, writes_per_tier, doc_steps
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Fold one chunk boundary's meter drain (cumulative counters).
        Returns (newly cost-alerted, newly burn-alerted) (M,) masks."""
        b = np.asarray(observed, np.float64)
        w_pt = np.asarray(writes_per_tier, np.float64)
        ds_pt = np.asarray(doc_steps, np.float64)
        active = b > self.seen
        dw = w_pt - self.writes_pt
        dsteps = ds_pt - self.doc_steps_pt
        mean, var_c = chunk_law_np(self.seen, b, self.k)
        width = np.maximum(b - self.seen, 0.0)
        wfrac = interval_tier_widths(self.bounds, self.seen, b) \
            / np.maximum(width, 1.0)[:, None]
        avg_cw = (wfrac * self.cw).sum(1)
        avg_cw2 = (wfrac * self.cw * self.cw).sum(1)
        exp_wcost = np.where(active, mean * avg_cw, 0.0)
        var_cost = np.where(active, var_c * avg_cw2, 0.0)
        real_wcost = np.where(active, (dw * self.cw).sum(1), 0.0)
        d = real_wcost - exp_wcost
        self.exp_writes_pt += np.where(active, mean, 0.0)[:, None] * wfrac
        # storage: realized doc-steps vs the survivor law's expectation
        # at the chunk end (right-Riemann — the device's own accrual)
        occ = np.where(self.logmem[:, None], self.exp_writes_pt,
                       expected_occupancy(self.bounds, self.k, b))
        plan_store = np.where(active,
                              (occ * self.step_rate).sum(1) * width, 0.0)
        real_store = np.where(active,
                              (dsteps * self.step_rate).sum(1), 0.0)
        real_inc = real_wcost + real_store
        plan_inc = exp_wcost + plan_store
        self.realized_total += real_inc
        self.planned_total += plan_inc
        self.realized_wcost += real_wcost
        self.exp_wcost_total += exp_wcost
        self.var_total += var_cost
        self.dev += d
        self.var += var_cost
        self.exp_since += exp_wcost
        self.checks += active
        self.steps += 1
        self._hist.append((real_inc, plan_inc, d.copy(), var_cost,
                           exp_wcost))
        if self._hist_len and len(self._hist) > self._hist_len:
            self._hist.pop(0)
        extra = self._extra()
        a = self.a_const + extra
        whole = np.abs(self.dev) > bernstein_threshold_weighted(
            self.var, a, self.cmax) + self.law_slack * self.exp_since
        pos = (self.dev - self.min_dev) > bernstein_threshold_weighted(
            self.var - self.var_at_min, a, self.cmax) \
            + self.law_slack * (self.exp_since - self.exp_at_min)
        neg = (self.max_dev - self.dev) > bernstein_threshold_weighted(
            self.var - self.var_at_max, a, self.cmax) \
            + self.law_slack * (self.exp_since - self.exp_at_max)
        hit = active & (whole | pos | neg)
        newly = hit & ~self.alerted
        first = newly & (self.first_alert_step < 0)
        self.first_alert_step[first] = self.steps
        self.first_alert_seen[first] = b[first].astype(np.int64)
        self.alerted |= hit
        # the burn channel: both-window overspend + its Bernstein gate
        burn_hit = np.zeros(self.m, bool)
        budget = self.budget_factor
        for long_w, short_w, ratio in self.burn_windows:
            if not self._hist:
                continue
            rl, pl, dl, vl, el = (np.sum([h[i] for h in self._hist[-long_w:]],
                                         axis=0) for i in range(5))
            rs = np.sum([h[0] for h in self._hist[-short_w:]], axis=0)
            ps = np.sum([h[1] for h in self._hist[-short_w:]], axis=0)
            breach = (pl > 0.0) & (rl > ratio * budget * pl) \
                & (rs > ratio * budget * ps)
            gate = dl > bernstein_threshold_weighted(vl, a, self.cmax) \
                + self.law_slack * el
            burn_hit |= active & breach & gate
        # outage-aware gating: rows inside an evacuation grace window
        # never raise burn (the expected-cost trajectory was credited
        # with the forced relocation bill via ``add_planned``)
        burn_hit &= self.steps > self.burn_suppressed_until
        newly_burn = burn_hit & ~self.burn_alerted
        fb = newly_burn & (self.first_burn_seen < 0)
        self.first_burn_seen[fb] = b[fb].astype(np.int64)
        self.burn_alerted |= burn_hit
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
        self.writes_pt = w_pt.copy()
        self.doc_steps_pt = ds_pt.copy()
        return newly, newly_burn

    def scores(self) -> np.ndarray:
        """(M,) max test statistic over its threshold (≥ 1 ⇒ alert)."""
        a = self.a_const + self._extra()
        whole = np.abs(self.dev) / np.maximum(
            bernstein_threshold_weighted(self.var, a, self.cmax)
            + self.law_slack * self.exp_since, 1e-12)
        pos = (self.dev - self.min_dev) / np.maximum(
            bernstein_threshold_weighted(self.var - self.var_at_min, a,
                                         self.cmax)
            + self.law_slack * (self.exp_since - self.exp_at_min), 1e-12)
        neg = (self.max_dev - self.dev) / np.maximum(
            bernstein_threshold_weighted(self.var - self.var_at_max, a,
                                         self.cmax)
            + self.law_slack * (self.exp_since - self.exp_at_max), 1e-12)
        return np.maximum(whole, np.maximum(pos, neg))

    def burn_ratio(self) -> np.ndarray:
        """(M,) realized / planned spend over the longest burn window
        (1.0 where the window's plan is zero) — the dashboard gauge."""
        out = np.ones(self.m, np.float64)
        if not self._hist or not self.burn_windows:
            return out
        long_w = max(l for l, _, _ in self.burn_windows)
        rl = np.sum([h[0] for h in self._hist[-long_w:]], axis=0)
        pl = np.sum([h[1] for h in self._hist[-long_w:]], axis=0)
        good = pl > 0.0
        out[good] = rl[good] / pl[good]
        return out

    def reset_where(self, mask) -> None:
        """Restart the masked streams' evidence (after a re-plan);
        cumulative baselines and the regret totals are preserved."""
        mask = np.asarray(mask, bool)
        for name in ("dev", "var", "min_dev", "var_at_min", "max_dev",
                     "var_at_max", "exp_since", "exp_at_min", "exp_at_max"):
            getattr(self, name)[mask] = 0.0
        for h in self._hist:
            for arr in h:
                arr[mask] = 0.0
        self.checks[mask] = 0
        self.alerted[mask] = False
        self.burn_alerted[mask] = False

    def suppress_burn(self, mask, steps: int) -> None:
        """Gate the masked streams' burn channel off for ``steps`` more
        monitor steps (chunks).  Used by tier-outage evacuation: the
        forced relocation's spend spike is operator-induced, not tenant
        overspend, so the burn alert must not fire on it."""
        mask = np.asarray(mask, bool)
        until = self.steps + int(steps)
        self.burn_suppressed_until[mask] = np.maximum(
            self.burn_suppressed_until[mask], until)

    def add_planned(self, row: int, amount: float) -> None:
        """Credit one stream's planned trajectory with an out-of-law
        bill (e.g. a forced evacuation's relocation cost) so ``regret``
        does not blame the placement for an operator decision."""
        self.planned_total[row] += float(amount)

    # ---- crash-consistent checkpointing ---------------------------------
    _STATE_ARRAYS = (
        "bounds", "seen", "writes_pt", "doc_steps_pt", "exp_writes_pt",
        "dev", "var", "min_dev", "var_at_min", "max_dev", "var_at_max",
        "exp_since", "exp_at_min", "exp_at_max", "checks", "alerted",
        "burn_alerted", "first_alert_step", "first_alert_seen",
        "first_burn_seen", "burn_suppressed_until", "realized_total",
        "planned_total", "realized_wcost", "exp_wcost_total", "var_total")

    def state_dict(self) -> dict:
        """All mutable state as fresh numpy copies (safe to hand to an
        async checkpoint writer while the engine keeps mutating)."""
        out = {name: getattr(self, name).copy()
               for name in self._STATE_ARRAYS}
        out["steps"] = np.int64(self.steps)
        out["hist"] = (np.stack([np.stack(h) for h in self._hist])
                       if self._hist
                       else np.zeros((0, 5, self.m), np.float64))
        return out

    def load_state(self, state: dict) -> None:
        for name in self._STATE_ARRAYS:
            ref = getattr(self, name)
            arr = np.asarray(state[name]).astype(ref.dtype).reshape(
                ref.shape)
            setattr(self, name, arr.copy())
        self.steps = int(state["steps"])
        hist = np.asarray(state["hist"], np.float64)
        self._hist = [tuple(hist[i, j].copy() for j in range(5))
                      for i in range(hist.shape[0])]

    def cost_z(self) -> dict:
        """(M,) whole-run realized vs expected cost-weighted writes with
        the z-score under the cost-weighted variance budget (law_slack
        folded in as a systematic term, like ``ResidualMonitor``)."""
        resid = self.realized_wcost - self.exp_wcost_total
        var_eff = self.var_total \
            + (self.law_slack * self.exp_wcost_total) ** 2
        z = resid / np.sqrt(np.maximum(var_eff, 1e-24))
        z = np.where(self.seen > 0, z, 0.0)
        return {"realized": self.realized_wcost.copy(),
                "expected": self.exp_wcost_total.copy(),
                "residual": resid, "var": var_eff, "z": z}

    def regret(self) -> np.ndarray:
        """(M,) realized − planned write+storage spend so far."""
        return self.realized_total - self.planned_total

    def snapshot(self) -> dict:
        sc = self.scores()
        br = self.burn_ratio()
        return {"cost_alerted": int(self.alerted.sum()),
                "burn_alerted": int(self.burn_alerted.sum()),
                "max_score": float(sc.max()) if sc.size else 0.0,
                "max_burn_ratio": float(br.max()) if br.size else 0.0,
                "checks": int(self.checks.max()) if self.m else 0,
                "steps": self.steps}
