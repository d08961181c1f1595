"""Cost attribution on the PyTorch/CUDA port: a budget burn-rate alert
fires a re-plan that bends the realized-cost curve back toward the
planned trajectory. The port of examples/cost_attribution.py, with the
same flags and defaults, on the CUDA card unless ``--device`` names
another.

Fleet of two-tier tenants whose cold tier charges expensive writes (the
flash write-amplification regime) while the planner's a-priori boundary
keeps only the early stream prefix hot. Half the tenants drift: their
score distribution heats up mid-window (rate multiplier), so admissions
keep landing in the expensive cold tier at several times the planned
rate. The drift detector is configured nearly blind (tiny alpha) — it
is the *cost* channel (``ObsConfig(costs=True, cost_trigger=True)``)
that notices: realized spend runs past the closed-form expected-cost
trajectory, the multi-window budget burn-rate rule fires a
``budget_burn`` event, and the alert unions into the re-plan trigger.
The suffix re-solve widens the hot tier, future admits become cheap,
and the realized-cost slope drops — which this script checks, along
with the per-tenant regret table (``online.evaluate.regret_table``).

Run (on the card): PYTHONPATH=src python examples_torch/cost_attribution.py
Run (on the CPU):
  PYTHONPATH=src python examples_torch/cost_attribution.py --device cpu
"""
from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import constraints as cons
from repro_torch.core import costs, simulator
from repro_torch.obs import Observability, ObsConfig
from repro_torch.online import DriftConfig, ReplanConfig, evaluate
from repro_torch.streams.engine import StreamEngine, StreamSpec


def make_model(n: int, k: int) -> costs.TwoTierCostModel:
    """Cheap-to-write hot tier, expensive-to-write cold tier: the regime
    where admitting past the boundary is what burns the budget."""
    wl = costs.WorkloadSpec(n_docs=n, k=k, doc_gb=1e-4, window_months=0.5)
    hot = costs.TierCosts("hot", put_per_doc=1e-6, get_per_doc=2.7e-4,
                          storage_per_gb_month=0.05)
    cold = costs.TierCosts("cold", put_per_doc=8e-5, get_per_doc=1e-6,
                           storage_per_gb_month=0.02)
    return costs.TwoTierCostModel(tier_a=hot, tier_b=cold, workload=wl)


def make_fleet(m, n, k, drift_at, mult, seed):
    rng = np.random.default_rng(seed)
    cm = make_model(n, k)
    drifted = [i < m // 2 for i in range(m)]
    traces = np.stack([
        simulator.drifted_rank_trace(n, rng, [(drift_at, mult)])
        if drifted[i] else simulator.random_rank_trace(n, rng)
        for i in range(m)])
    specs = [StreamSpec(stream_id=i, k=k, cost_model=cm) for i in range(m)]
    cset = cons.ConstraintSet(cons.TierCapacity(0, 4 * k))
    return traces, specs, cset, np.asarray(drifted)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--docs", type=int, default=12000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--drift-at", type=int, default=3000)
    ap.add_argument("--multiplier", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--oracle-grid", type=int, default=6,
                    help="hindsight-oracle sweep size for the regret "
                         "table (0 = skip the oracle column)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write obs artifacts (metrics/events) to DIR")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the CUDA "
                         "card; no fallback to the CPU)")
    return ap.parse_args(argv)


def run(args):
    """The burn alert -> cost-triggered re-plan -> flatter realized-cost
    chain and the regret table, as the reference's example, printing its
    lines. Returns a namespace of engine, obs, cost_replans (the applied
    cost-triggered re-plans), table (the regret rows) and failures."""
    dev = device_mod.for_script(args.device)

    m, n, k = args.streams, args.docs, args.k
    traces, specs, cset, drifted = make_fleet(
        m, n, k, args.drift_at, args.multiplier, args.seed)
    obs = Observability(ObsConfig(
        costs=True, cost_trigger=True, cost_alpha=0.01,
        budget_factor=1.2))
    # the detector is nearly blind (tiny alpha → huge thresholds): any
    # re-plan in this run is driven by the cost/burn channel
    eng = StreamEngine(specs, obs=obs, constraints=cset,
                       replan=ReplanConfig(drift=DriftConfig(alpha=1e-9)),
                       device=dev)

    sids = np.arange(m)
    realized_curve, planned_curve = [], []
    for t0 in range(0, n, args.chunk):
        c = min(args.chunk, n - t0)
        eng.ingest(np.repeat(sids, c),
                   traces[:, t0:t0 + c].reshape(-1),
                   np.tile(t0 + np.arange(c), m))
        mon = eng._cost_monitor
        realized_curve.append(mon.realized_total[drifted].sum())
        planned_curve.append(mon.planned_total[drifted].sum())
    eng.finalize()
    realized_curve = np.asarray(realized_curve)
    planned_curve = np.asarray(planned_curve)

    failures = []

    # --- the alert → re-plan chain -------------------------------------
    burns = [e for e in obs.tracer.events if e["name"] == "budget_burn"]
    alerts = [e for e in obs.tracer.events if e["name"] == "cost_alert"]
    print(f"cost alerts: {len(alerts)}, budget burns: {len(burns)}")
    for e in burns[:4]:
        a = e["attrs"]
        print(f"  burn: stream {a['stream_id']} at position "
              f"{a['position']} (realized/planned over the long window "
              f"= {a['burn_ratio']:.2f})")
    if not any(drifted[e["attrs"]["row"]] for e in burns + alerts):
        failures.append("no cost/burn alert fired on a drifted stream")

    cost_replans = [
        e["attrs"] for e in obs.tracer.events
        if e["name"] == "replan_decision"
        and e["attrs"]["cost_triggered"] and e["attrs"]["applied"]]
    if not cost_replans:
        failures.append("no applied re-plan was cost-triggered")
        first_replan_pos = None
    else:
        first = min(cost_replans, key=lambda a: a["position"])
        first_replan_pos = int(first["position"])
        print(f"cost-triggered re-plan: stream {first['stream_id']} at "
              f"position {first_replan_pos} "
              f"(moved {first['moved_docs']} residents)")

    # --- the curve bends ------------------------------------------------
    if first_replan_pos is not None:
        dc = args.drift_at // args.chunk
        rc = min(first_replan_pos // args.chunk, len(realized_curve) - 3)
        pre = (realized_curve[rc] - realized_curve[dc]) / max(rc - dc, 1)
        post = (realized_curve[-1] - realized_curve[rc + 1]) \
            / max(len(realized_curve) - rc - 2, 1)
        plan_slope = (planned_curve[-1] - planned_curve[rc + 1]) \
            / max(len(planned_curve) - rc - 2, 1)
        print(f"realized-cost slope (drifted tenants, per {args.chunk}-doc "
              f"chunk): pre-replan {pre:.3e} → post-replan {post:.3e} "
              f"(planned {plan_slope:.3e})")
        if not post < pre:
            failures.append(
                f"re-plan did not bend the cost curve: post {post:.3e} "
                f">= pre {pre:.3e}")

    # --- the regret table -----------------------------------------------
    table = evaluate.regret_table(
        eng, traces,
        drift_at=args.drift_at if args.oracle_grid else None,
        grid=args.oracle_grid)
    print()
    print(evaluate.format_regret_table(table))
    worst_drifted = max(table[i]["regret"] for i in range(m) if drifted[i])
    worst_calm = max(table[i]["regret"] for i in range(m) if not drifted[i])
    if not worst_drifted > worst_calm:
        failures.append("drifted tenants should out-regret calm ones "
                        f"({worst_drifted:.3e} vs {worst_calm:.3e})")

    snap = eng.obs_snapshot()["costs"]
    print(f"\nfleet: realized={snap['realized']['total']:.3e} "
          f"planned={snap['planned_total']:.3e} "
          f"regret={snap['regret']['fleet']:+.3e} "
          f"(alerts: cost={snap['alerts']['cost_alerted']} "
          f"burn={snap['alerts']['burn_alerted']})")

    if args.out:
        paths = obs.write(args.out)
        print("obs artifacts: " + ", ".join(sorted(paths.values())))

    if failures:
        print("\nFAILURES:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        raise SystemExit(1)
    print("\nOK: budget burn alert → cost-triggered re-plan → flattened "
          "realized-cost curve")
    return SimpleNamespace(engine=eng, obs=obs, cost_replans=cost_replans,
                           table=table, failures=failures)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
