"""Fleet telemetry on the PyTorch/CUDA port: model-referenced residuals
catch drift at (or before) the in-step CUSUM detector, with the full obs
artifact trail. The port of examples/fleet_telemetry.py, with the same
flags and defaults, on the CUDA card unless ``--device`` names another.

A fleet of two-tier tenants runs the paper's Algorithm C shape; mid-window
every stream's record rate jumps 8x. Two independent watchers see it:

  1. the engine step's ``DriftEstimator`` (a CUSUM over the analytic K/t
     entry law, on the engine's device), which triggers the constrained
     re-solve;
  2. ``repro_torch.obs``'s ``ResidualMonitor`` — a host-side replica
     built purely from the meter's cumulative write counters, testing the
     realized-minus-expected residual against the same Bernstein
     concentration budgets.

Because the monitor's excursion statistic equals the detector's CUSUM
statistic, the alert channel flags every drifted stream in the same
chunk the detector fires — before the re-planner consumes the evidence.
The script prints the per-stream race, writes the metrics.json /
metrics.prom / events.jsonl artifacts, and then re-runs the identical
fleet config. Where the reference asserts that its jit caches are warm,
the port checks its one compile cache, the kernels' nvcc build (probe
``"kernels.build"``): on the card the probe must be registered and the
re-run must compile nothing; on the CPU nothing is built, and the script
says so and skips that check.

Run (on the card): PYTHONPATH=src python examples_torch/fleet_telemetry.py
Run (small, on the CPU):
  PYTHONPATH=src python examples_torch/fleet_telemetry.py --device cpu \\
      --streams 3 --docs 4000 --drift-at 1000 --out /tmp/obs_out
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import constraints as cons
from repro_torch.core import costs, simulator
from repro_torch.obs import Observability, ObsConfig, jits
from repro_torch.online import DriftConfig, ReplanConfig, evaluate
from repro_torch.streams import StreamSpec

BUILD_PROBE = "kernels.build"  # the port's one compile cache (obs.jits)


def make_fleet(m: int, docs: int, k: int):
    """Interior-crossover two-tier tenants (write-cheap/read-expensive
    hot tier) so the planner puts every boundary mid-stream."""
    specs = []
    for i in range(m):
        wl = costs.WorkloadSpec(n_docs=docs, k=k, doc_gb=1e-4,
                                window_months=0.5)
        hot = costs.TierCosts("hot", put_per_doc=1e-6, get_per_doc=2.7e-4,
                              storage_per_gb_month=0.05)
        cold = costs.TierCosts("cold", put_per_doc=8e-5, get_per_doc=1e-6,
                               storage_per_gb_month=0.02)
        specs.append(StreamSpec(
            stream_id=i, k=k,
            cost_model=costs.TwoTierCostModel(tier_a=hot, tier_b=cold,
                                              workload=wl)))
    return specs


def run_once(traces, specs, args, obs, device=None):
    return evaluate.run_fleet(
        traces, specs,
        replan=ReplanConfig(drift=DriftConfig(alpha=args.alpha)),
        chunk=args.chunk,
        constraints=cons.ConstraintSet(cons.TierCapacity(0, 4 * args.k)),
        obs=obs, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=6)
    ap.add_argument("--docs", type=int, default=12000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--drift-at", type=int, default=3000)
    ap.add_argument("--multiplier", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default="obs_out",
                    help="directory for the obs artifacts")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the CUDA "
                         "card; no fallback to the CPU)")
    return ap.parse_args(argv)


def run(args):
    """Both watchers, the race, the regret table, the artifacts and the
    compile-cache check on an identical re-run, as the reference's
    example, printing its lines. Returns a namespace of traces, engine,
    alerts, detected, snapshot, regret (the table's rows), paths (the
    artifacts) and failures."""
    dev = device_mod.for_script(args.device)
    rng = np.random.default_rng(args.seed)

    specs = make_fleet(args.streams, args.docs, args.k)
    traces = np.stack([
        simulator.drifted_rank_trace(args.docs, rng,
                                     [(args.drift_at, args.multiplier)])
        for _ in range(args.streams)])

    obs = Observability(ObsConfig(residual_alpha=args.alpha, costs=True))
    t0 = time.time()
    engine = run_once(traces, specs, args, obs, dev)
    print(f"fleet of {args.streams} x {args.docs} docs "
          f"({args.multiplier:g}x drift at {args.drift_at}) in "
          f"{time.time() - t0:.1f}s")

    # --- the race: residual alert channel vs in-step CUSUM detector ------
    alerts = engine.residual_alerts()
    detected = {}
    for ev in engine.replan_events:
        detected.setdefault(ev.stream_id, ev.position)
    failures = []
    won = 0
    print("stream  residual-alert  cusum-detect  alert<=detect")
    for sid in range(args.streams):
        a, d = alerts.get(sid), detected.get(sid)
        ok = a is not None and d is not None and a <= d
        won += ok
        print(f"{sid:>6}  {str(a):>14}  {str(d):>12}  {str(ok):>13}")
    frac = won / max(len(detected), 1)
    print(f"residual channel at-or-before CUSUM on {won}/{len(detected)} "
          f"detected streams ({frac:.0%})")
    if frac < 0.9:
        failures.append("residual alerts trailed the CUSUM detector")

    snap = engine.obs_snapshot()
    wz = snap["residuals"]["writes"]
    print(f"write-law residual: fleet realized={wz['fleet_realized']:.0f} "
          f"expected={wz['fleet_expected']:.1f} max|z|={wz['max_abs_z']:.2f}")
    em = snap["engine"]
    print(f"device counters: docs={em['docs']} admits={em['admits']} "
          f"evictions={em['evictions']} "
          f"filter_pass_rate={em['filter_pass_rate']:.3f} "
          f"chunks={em['chunks']}")

    # --- per-tenant cost attribution: realized vs planned regret ---------
    print()
    regret = evaluate.regret_table(engine)
    print(evaluate.format_regret_table(regret))
    cm = engine.cost_summary()
    if not np.all(np.isfinite(cm["regret"])):
        failures.append("non-finite regret in the cost summary")

    paths = obs.write(args.out)
    print("obs artifacts: " + ", ".join(sorted(paths.values())))

    # --- compile-cache introspection: an identical config must be all
    # hits. The port's one compile cache is the kernels' nvcc build
    # (probe "kernels.build"); on the CPU nothing is built.
    before = {name: p["misses"] for name, p in jits.snapshot().items()}
    run_once(traces, specs, args, Observability(ObsConfig(
        residual_alpha=args.alpha, costs=True)), dev)
    after = jits.snapshot()
    for name, p in sorted(after.items()):
        new_misses = p["misses"] - before.get(name, 0)
        print(f"jit probe {name}: calls={p['calls']} misses={p['misses']} "
              f"compile_s={p['compile_s']:.2f} "
              f"(re-run recompiles: {new_misses})")
        if new_misses:
            failures.append(
                f"jit probe {name} recompiled on an identical re-run")
    if dev.type != "cuda":
        print(f"jit probe {BUILD_PROBE}: not checked on {dev} (no kernel "
              f"is built off the card)")
    elif BUILD_PROBE not in after:
        failures.append(f"jit probe {BUILD_PROBE} not registered")

    if failures:
        raise SystemExit("; ".join(failures))
    print("fleet telemetry demo OK")
    return SimpleNamespace(traces=traces, engine=engine, alerts=alerts,
                           detected=detected, snapshot=snap, regret=regret,
                           paths=paths, failures=failures)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
