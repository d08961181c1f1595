"""End-to-end evaluation harness for online re-planning: drive the fleet
engine over (possibly drifted) traces, extract the applied boundary
deltas as simulator schedules, and compare realized costs against the
static a-priori plan and a drift-aware ground-truth oracle.

Two ground-truth oracles, both applied at the (known) drift onset:

* ``process_oracle`` — knows the drift *process* (onset + multiplier
  schedule) but not the realization: each candidate suffix boundary
  vector is scored on independent probe traces drawn from the same
  drifted distribution, the winner is then applied to the actual trace.
  This is the fair "drift-aware oracle plan" — a plan cannot know the
  future noise — and the acceptance bar ("re-planned within 10%").
* ``hindsight_oracle`` — additionally knows the realization (sweeps the
  very trace being scored): an unbeatable per-trace lower bound, useful
  for calibration.

The re-planner only sees the detector's evidence, so tracking the
process oracle means the closed loop recovers most of what perfect drift
knowledge would.

A copy of the reference's ``online.evaluate``: ``run_fleet`` and
``evaluate_fleet`` also take ``device=`` and run the engine on the CUDA
card unless the caller passes another device."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import simulator
from repro_torch.core.placement import Policy
from repro_torch.obs import timers
from repro_torch.streams.engine import StreamEngine, StreamSpec


def run_fleet(traces: np.ndarray, specs: Sequence[StreamSpec], *,
              replan=None, chunk: int = 64, constraints=None,
              rng: Optional[np.random.Generator] = None,
              obs=None, device=None) -> StreamEngine:
    """Feed per-stream traces (M, N) through a fresh ``StreamEngine`` on
    ``device`` (the CUDA card unless given) in width-``chunk`` steps
    (batches shuffled across tenants when ``rng`` is given) and finalize.
    Returns the engine (events, meter, survivors). ``obs`` (a
    ``repro_torch.obs.Observability``) threads the telemetry layer
    through the engine — device metric counters, residual alert channel,
    span timeline."""
    m, n = traces.shape
    engine = StreamEngine(specs, replan=replan, constraints=constraints,
                          obs=obs, device=device)
    sids = np.array([s.stream_id for s in specs])
    tracer = obs.tracer if obs is not None else None
    with timers.span("online.run_fleet", tracer=tracer, m=m, n=n,
                     chunk=chunk):
        for t0 in range(0, n, chunk):
            w = min(chunk, n - t0)
            mixed_sids = np.repeat(sids, w)
            mixed_dids = np.tile(np.arange(t0, t0 + w), m)
            mixed_scores = traces[:, t0:t0 + w].reshape(-1)
            if rng is not None:
                perm = rng.permutation(mixed_sids.size)
                mixed_sids, mixed_dids, mixed_scores = (
                    mixed_sids[perm], mixed_dids[perm], mixed_scores[perm])
            engine.ingest(mixed_sids, mixed_scores, mixed_dids)
        engine.finalize()
    return engine


def schedules_from_events(engine: StreamEngine) -> Dict[int, List[Tuple]]:
    """{stream_id: [(position, new_bounds), ...]} of the applied deltas."""
    out: Dict[int, List[Tuple]] = {}
    for ev in engine.replan_events:
        if ev.applied:
            out.setdefault(ev.stream_id, []).append(
                (ev.position, ev.new_bounds))
    return out


def realized(trace, k: int, cm, bounds, migrate: bool = False,
             schedule=None) -> simulator.SimResult:
    """Replay one stream through ``core.simulator`` under a (possibly
    re-scheduled) boundary placement, with metered rental."""
    pol = Policy(boundaries=tuple(float(b) for b in bounds),
                 migrate_at_r=migrate)
    return simulator.simulate(np.asarray(trace, np.float64), k, pol,
                              cost_model=cm, boundary_schedule=schedule)


def _oracle_candidates(n: int, k: int, base_bounds, grid: int):
    vals = np.unique(np.concatenate([
        [0.0, float(n)], np.asarray(base_bounds, np.float64),
        np.geomspace(max(k, 1.0), n, grid)]))
    b = len(base_bounds)
    return [tuple(float(x) for x in combo)
            for combo in itertools.combinations_with_replacement(vals, b)]


def hindsight_oracle(trace, k: int, cm, base_bounds, drift_at: int, *,
                     grid: int = 16) -> Tuple[float, Tuple[float, ...]]:
    """Per-trace lower bound: sweep suffix boundary vectors applied at
    the (known) drift onset on the very trace being scored and keep the
    cheapest realized cost — including the do-nothing option, so it never
    loses to the static plan. Exponential in the boundary count; keep
    ``grid`` small beyond two tiers."""
    best = realized(trace, k, cm, base_bounds).cost_total
    best_bounds = tuple(float(x) for x in base_bounds)
    for combo in _oracle_candidates(trace.shape[0], k, base_bounds, grid):
        cost = realized(trace, k, cm, base_bounds,
                        schedule=[(drift_at, combo)]).cost_total
        if cost < best:
            best, best_bounds = cost, tuple(float(x) for x in combo)
    return best, best_bounds


def process_oracle(trace, k: int, cm, base_bounds, drift_at: int,
                   multipliers, rng: np.random.Generator, *,
                   grid: int = 16, probes: int = 3
                   ) -> Tuple[float, Tuple[float, ...]]:
    """The drift-aware oracle *plan*: knows the drift process (onset +
    multiplier schedule) but not the realization. Candidates (including
    do-nothing) are scored by mean realized cost over ``probes``
    independent traces drawn from the same drifted distribution; the
    winning boundary vector is then applied to the actual trace. Returns
    (realized cost on ``trace``, chosen bounds)."""
    n = trace.shape[0]
    probe_traces = [simulator.drifted_rank_trace(n, rng, multipliers)
                    for _ in range(probes)]
    cands = [tuple(float(x) for x in base_bounds)]
    cands += _oracle_candidates(n, k, base_bounds, grid)
    best_mean, best_bounds = np.inf, cands[0]
    for combo in cands:
        sched = (None if combo == tuple(base_bounds)
                 else [(drift_at, combo)])
        mean = np.mean([realized(t, k, cm, base_bounds,
                                 schedule=sched).cost_total
                        for t in probe_traces])
        if mean < best_mean:
            best_mean, best_bounds = mean, combo
    sched = (None if best_bounds == tuple(base_bounds)
             else [(drift_at, best_bounds)])
    return realized(trace, k, cm, base_bounds,
                    schedule=sched).cost_total, best_bounds


@dataclass
class FleetEvaluation:
    """Per-stream realized costs of the three placements."""

    static_cost: np.ndarray  # (M,)
    replanned_cost: np.ndarray  # (M,)
    oracle_cost: np.ndarray  # (M,) NaN when the oracle sweep was skipped
    schedules: Dict[int, List[Tuple]]
    engine: StreamEngine
    timings: Dict[str, float] = field(default_factory=dict)  # phase seconds

    @property
    def fleet_static(self) -> float:
        return float(self.static_cost.sum())

    @property
    def fleet_replanned(self) -> float:
        return float(self.replanned_cost.sum())

    @property
    def fleet_oracle(self) -> float:
        return float(np.nansum(self.oracle_cost))


def evaluate_fleet(traces: np.ndarray, specs: Sequence[StreamSpec], *,
                   replan, drift_at: Optional[int] = None, chunk: int = 64,
                   constraints=None, oracle_grid: int = 16,
                   drift_schedule=None, oracle_probes: int = 3,
                   rng: Optional[np.random.Generator] = None,
                   obs=None, device=None) -> FleetEvaluation:
    """Run the closed loop over the fleet, then score static vs replanned
    realized costs per stream. With ``drift_at`` the oracle column is
    filled too: the process oracle when ``drift_schedule`` (the true
    multiplier schedule) is given, else the per-trace hindsight bound.
    ``specs`` must carry cost models. The engine runs on ``device`` (the
    CUDA card unless given); ``obs`` threads the telemetry layer through
    the run; the phase wall times land in ``FleetEvaluation.timings``
    (and, with ``obs``, on the span timeline)."""
    tracer = obs.tracer if obs is not None else None
    with timers.span("online.evaluate.engine", tracer=tracer) as sp_run:
        engine = run_fleet(traces, specs, replan=replan, chunk=chunk,
                           constraints=constraints, rng=rng, obs=obs,
                           device=device)
    m = traces.shape[0]
    schedules = schedules_from_events(engine)
    static_cost = np.zeros(m)
    replanned_cost = np.zeros(m)
    oracle_cost = np.full(m, np.nan)
    with timers.span("online.evaluate.score", tracer=tracer) as sp_score:
        for i, spec in enumerate(specs):
            row = engine.stream_row(spec.stream_id)
            base = tuple(b for b in engine.meter.boundaries[row]
                         if np.isfinite(b))
            # the meter's row holds the *current* (possibly re-planned)
            # boundaries; the a-priori vector is the first event's old
            # bounds
            for ev in engine.replan_events:
                if ev.stream_id == spec.stream_id:
                    base = ev.old_bounds
                    break
            mig = bool(engine.meter.migrate[row])
            static_cost[i] = realized(traces[i], spec.k, spec.cost_model,
                                      base, mig).cost_total
            sched = schedules.get(spec.stream_id)
            replanned_cost[i] = realized(traces[i], spec.k,
                                         spec.cost_model, base, mig,
                                         schedule=sched).cost_total
            if drift_at is not None and not mig:
                if drift_schedule is not None:
                    oracle_cost[i], _ = process_oracle(
                        traces[i], spec.k, spec.cost_model, base, drift_at,
                        drift_schedule,
                        (rng if rng is not None
                         else np.random.default_rng(i)),
                        grid=oracle_grid, probes=oracle_probes)
                else:
                    oracle_cost[i], _ = hindsight_oracle(
                        traces[i], spec.k, spec.cost_model, base, drift_at,
                        grid=oracle_grid)
    return FleetEvaluation(static_cost=static_cost,
                           replanned_cost=replanned_cost,
                           oracle_cost=oracle_cost, schedules=schedules,
                           engine=engine,
                           timings={"engine_s": sp_run.dur_s,
                                    "score_s": sp_score.dur_s})


def regret_table(engine: StreamEngine, traces=None, *,
                 drift_at: Optional[int] = None,
                 grid: int = 8) -> List[Dict]:
    """Per-tenant regret rows from a live engine's cost attribution
    (requires ``ObsConfig(costs=True)``): realized spend from the device
    ledger, the planner's closed-form expected spend, their difference
    (regret vs plan), and — when ``traces`` and ``drift_at`` are given —
    regret vs the per-trace hindsight oracle (``hindsight_oracle``), the
    strongest baseline the paper admits. Cascade streams skip the oracle
    column (the oracle sweeps static re-plans)."""
    summ = engine.cost_summary()
    rows: List[Dict] = []
    for row in range(engine.m):
        sid = engine._sid_of_row[row]
        entry = {"stream_id": sid, "row": row,
                 "realized": float(summ["total"][row]),
                 "planned": float(summ["planned"][row]),
                 "regret": float(summ["regret"][row]),
                 "oracle": float("nan"), "oracle_regret": float("nan")}
        cm = engine._model_of_row.get(row)
        if (traces is not None and drift_at is not None and cm is not None
                and not engine.meter.migrate[row]):
            base = tuple(b for b in engine.meter.boundaries[row]
                         if np.isfinite(b))
            for ev in engine.replan_events:
                if ev.stream_id == sid:
                    base = ev.old_bounds
                    break
            oc, _ = hindsight_oracle(np.asarray(traces[row]),
                                     int(engine.meter.ks[row]), cm, base,
                                     drift_at, grid=grid)
            entry["oracle"] = float(oc)
            entry["oracle_regret"] = entry["realized"] - float(oc)
        rows.append(entry)
    return rows


def format_regret_table(rows: Sequence[Dict]) -> str:
    """Fixed-width text rendering of ``regret_table`` rows (the README /
    example excerpt)."""
    header = (f"{'stream':>6} {'realized':>12} {'planned':>12} "
              f"{'regret':>12} {'vs oracle':>12}")
    lines = [header, "-" * len(header)]
    for r in rows:
        vs = ("-" if np.isnan(r["oracle_regret"])
              else f"{r['oracle_regret']:>12.4e}")
        lines.append(f"{r['stream_id']:>6} {r['realized']:>12.4e} "
                     f"{r['planned']:>12.4e} {r['regret']:>12.4e} {vs:>12}")
    tot_real = sum(r["realized"] for r in rows)
    tot_plan = sum(r["planned"] for r in rows)
    lines.append(f"{'fleet':>6} {tot_real:>12.4e} {tot_plan:>12.4e} "
                 f"{tot_real - tot_plan:>12.4e} {'':>12}")
    return "\n".join(lines)
