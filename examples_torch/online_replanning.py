"""Online re-planning on the PyTorch/CUDA port: detect mid-window drift
and re-solve the constrained plan in closed form, beating the static
a-priori placement. The port of examples/online_replanning.py, with the
same flags and defaults, on the CUDA card unless ``--device`` names
another.

A fleet of tenants runs the paper's two-tier Algorithm C shape (hot tier
write-cheap / read-expensive, interior r*). Mid-window, every stream's
record rate jumps by a piecewise multiplier (the weighted-record trace —
``simulator.drifted_rank_trace`` — whose entry law the detector and the
oracle both know analytically). The closed loop:

  1. ``DriftEstimator`` (inside the engine step, on the engine's device)
     flags the burst against the analytic K/t entry law,
  2. ``Replanner`` re-solves the constrained boundary objective over the
     remaining suffix (drift-conditioned write/read laws + relocation
     bill) and applies the delta,
  3. realized costs are replayed through ``core.simulator``: the
     re-planned fleet must beat the static plan and land within ~10% of
     a hindsight oracle that knows the drift onset, with zero
     reconciliation-time constraint violations.

Also demos ``AdmissionController``: an SLO-squeezed tenant that the
constrained planner would reject is admitted at a negotiated K.

Run (on the card): PYTHONPATH=src python examples_torch/online_replanning.py
Run (small, on the CPU):
  PYTHONPATH=src python examples_torch/online_replanning.py --device cpu \\
      --streams 4 --docs 4000 --drift-at 1000 --oracle-grid 3
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import constraints as cons
from repro_torch.core import costs, simulator, topology
from repro_torch.online import (AdmissionController, DriftConfig,
                                ReplanConfig, evaluate)
from repro_torch.streams import StreamSpec


def make_fleet(m: int, docs: int, k: int, rng: np.random.Generator):
    """Heterogeneous tenants around the interior-crossover shape: hot
    tier write-cheap / read-expensive, cold tier the reverse, costs
    jittered so every tenant gets its own r*."""
    specs = []
    for i in range(m):
        wl = costs.WorkloadSpec(n_docs=docs, k=k, doc_gb=1e-4,
                                window_months=0.5)
        hot = costs.TierCosts(
            "hot", put_per_doc=1e-6,
            get_per_doc=2.7e-4 * float(rng.uniform(0.9, 1.1)),
            storage_per_gb_month=0.05)
        cold = costs.TierCosts(
            "cold", put_per_doc=8e-5 * float(rng.uniform(0.9, 1.1)),
            get_per_doc=1e-6, storage_per_gb_month=0.02)
        cm = costs.TwoTierCostModel(tier_a=hot, tier_b=cold, workload=wl)
        specs.append(StreamSpec(stream_id=i, k=k, cost_model=cm))
    return specs


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--docs", type=int, default=12000)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--drift-at", type=int, default=3000)
    ap.add_argument("--multiplier", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--oracle-grid", type=int, default=10,
                    help="0 disables the hindsight-oracle sweep")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the CUDA "
                         "card; no fallback to the CPU)")
    return ap.parse_args(argv)


def run(args):
    """The closed loop and the admission negotiation as the reference's
    example runs them, printing its lines. Returns a namespace of ev (the
    ``FleetEvaluation``), engine, report (``check_constraints``) and
    decision (the admission)."""
    dev = device_mod.for_script(args.device)
    rng = np.random.default_rng(args.seed)

    specs = make_fleet(args.streams, args.docs, args.k, rng)
    traces = np.stack([
        simulator.drifted_rank_trace(args.docs, rng,
                                     [(args.drift_at, args.multiplier)])
        for _ in range(args.streams)])
    cset = cons.ConstraintSet(cons.TierCapacity(0, 4 * args.k))

    t0 = time.time()
    ev = evaluate.evaluate_fleet(
        traces, specs,
        replan=ReplanConfig(drift=DriftConfig(alpha=args.alpha)),
        drift_at=args.drift_at if args.oracle_grid else None,
        chunk=args.chunk, constraints=cset,
        oracle_grid=max(args.oracle_grid, 1),
        drift_schedule=[(args.drift_at, args.multiplier)], device=dev)
    engine = ev.engine
    applied = [e for e in engine.replan_events if e.applied]
    print(f"closed loop over {args.streams} streams x {args.docs} docs "
          f"({args.multiplier:g}x drift at {args.drift_at}) in "
          f"{time.time() - t0:.1f}s")
    print(f"replan events: {len(engine.replan_events)} "
          f"({len(applied)} applied, "
          f"{int(engine.meter.relocations.sum())} residents relocated)")
    for e in applied[: args.streams]:
        print(f"  tenant {e.stream_id} @ doc {e.position}: rho={e.rho:.2f} "
              f"r {e.old_bounds[0]:.0f} -> {e.new_bounds[0]:.0f} "
              f"(E[suffix] {e.suffix_cost_old:.4f} -> "
              f"{e.suffix_cost_new:.4f}, bill {e.move_bill:.5f})")

    print(f"fleet realized cost: static={ev.fleet_static:.4f} "
          f"replanned={ev.fleet_replanned:.4f} "
          f"({ev.fleet_replanned / ev.fleet_static:.1%} of static)")
    failures = []
    if ev.fleet_replanned >= ev.fleet_static:
        failures.append("re-planned fleet did not beat the static plan")
    if args.oracle_grid:
        print(f"drift-aware oracle plan: {ev.fleet_oracle:.4f} "
              f"(replanned is {ev.fleet_replanned / ev.fleet_oracle:.1%})")
        if ev.fleet_replanned > 1.10 * ev.fleet_oracle:
            failures.append("re-planned fleet missed the 10% oracle band")
    report = engine.check_constraints()
    print(f"constraint reconciliation ok: {report['ok']}")
    if not report["ok"]:
        failures.append("constraint violations at reconciliation")

    # --- admission control: negotiate instead of rejecting ---------------
    topo = topology.aws_archive_tiering()
    topo = topo.replace(tiers=(
        topo.tiers[0].__class__(topo.tiers[0].costs, capacity_docs=128,
                                read_latency_s=0.02),
        topo.tiers[1]))
    wl = costs.WorkloadSpec(n_docs=200_000, k=512, doc_gb=1e-3,
                            window_months=1.0)
    squeezed = topo.cost_model(wl)
    slo_set = cons.ConstraintSet(cons.ReadLatencySLO(60.0))
    dec = AdmissionController(slo_set).admit(squeezed)
    print(f"admission: K={wl.k} under a 60s SLO with a 128-doc hot tier "
          f"-> {dec.reason} (admitted={dec.admitted}, K={dec.k}, "
          f"window={dec.n_docs})")
    if not (dec.admitted and dec.negotiated and dec.k < wl.k):
        failures.append("admission controller failed to negotiate")

    if failures:
        raise SystemExit("; ".join(failures))
    print("online re-planning demo OK")
    return SimpleNamespace(ev=ev, engine=engine, report=report,
                           decision=dec)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
