"""Constrained placement worked example on the PyTorch/CUDA port's host
modules: per-tier capacities and read-path SLOs (``core.constraints``).
The port of examples/capacity_slo_cloud.py, with the same flags and
defaults. It runs on the host (``core.constraints``, ``shp``,
``simulator``) and touches no device, as the reference touches none, so
it takes no ``--device``.

The paper's closed forms assume unbounded tiers and free, instant reads.
Two production scenarios where that breaks:

1. **Bounded hot tier.** A local-NVMe hot tier in front of S3 holds
   C_0 ≪ K documents. The unconstrained planner would keep the first
   r* ≥ K arrivals hot; the capacity constraint forces *early demotion*
   — the hot boundary clamps to C_0 (and the migration cascade, which
   needs the whole reservoir in one tier, becomes infeasible outright).
   A scaled-down trace replay confirms the metered occupancy high-water
   mark stays under C_0.

2. **Archival retrieval SLO.** S3 Standard → Glacier Flexible Retrieval
   rents ~6x cheaper at the bottom, but a standard retrieval takes
   hours. A per-survivor expected-read-latency SLO prices that delay:
   the constrained planner pulls the cold boundary up (bounding the
   fraction of survivors parked in Glacier) or abandons the archive
   tier entirely — the SLO forces the planner *off the cheapest tier*.

Run: PYTHONPATH=src python examples_torch/capacity_slo_cloud.py
"""
from __future__ import annotations

import argparse
import math
from types import SimpleNamespace

import numpy as np

from repro_torch.core import costs, placement, shp, simulator, topology
from repro_torch.core.constraints import (ConstraintSet, ReadLatencySLO,
                                    TierCapacity, expected_read_latency,
                                    peak_occupancy)


def fmt_plan(tag, model, plan):
    occ = peak_occupancy(plan.boundaries, model.workload.n_docs,
                         model.workload.k, plan.migrate)
    lat = expected_read_latency(plan.boundaries, model.workload.n_docs,
                                model.read_latency, plan.migrate)
    bs = ", ".join(f"{b / model.workload.n_docs:.4f}"
                   for b in plan.boundaries)
    occs = ", ".join(f"{o:,.0f}" for o in occ)
    print(f"{tag:<14}{plan.strategy:<22}${plan.total:>10.2f}  b/N=[{bs}]  "
          f"peak occ=[{occs}]  E[read lat]={lat:.3g}s")
    return occ, lat


def capacity_example(args):
    print("=" * 72)
    print("1. bounded hot tier: producer-local NVMe (C_0 ≪ K) -> S3")
    print("=" * 72)
    # NVMe next to the producer: writes are free, rental is amortized
    # hardware, but the consumer pulls reads across the network; S3 sits
    # next to the consumer and charges per-request on the write path.
    nvme = costs.TierCosts("local-nvme", put_per_doc=0.0, get_per_doc=0.0,
                           storage_per_gb_month=0.01)
    s3 = costs.TierCosts("aws-s3", put_per_doc=0.005 / 1000,
                         get_per_doc=0.0004 / 1000,
                         storage_per_gb_month=0.023)
    cap0 = args.k // 20  # the NVMe slab holds 5% of the reservoir
    topo = topology.TierTopology(tiers=(
        topology.TierSpec(nvme, xfer_out_per_gb=0.2, read_latency_s=1e-4,
                          capacity_docs=float(cap0)),
        topology.TierSpec(s3, xfer_in_per_gb=0.02, read_latency_s=0.02),
    ), name="nvme-s3")
    wl = costs.WorkloadSpec(n_docs=args.n_docs, k=args.k, doc_gb=1e-4,
                            window_months=1.0)
    model = topo.cost_model(wl)
    # an explicit TierCapacity(0, inf) *overrides* the topology-declared
    # C_0 (declarations otherwise always apply) — the what-if baseline
    unconstrained = shp.plan_placement_ntier(
        model, constraints=ConstraintSet(TierCapacity(0, math.inf)))
    constrained = shp.plan_placement_ntier(model)  # topology-declared C_0
    fmt_plan("unconstrained", model, unconstrained)
    occ, _ = fmt_plan("C_0=%d" % cap0, model, constrained)
    if not (occ[0] <= cap0 * (1 + 1e-9)
            and constrained.boundaries[0] <= cap0
            and unconstrained.boundaries[0] > args.k
            > constrained.boundaries[0]):
        raise SystemExit("the capacity did not force early demotion")
    print(f"-> early demotion: the unconstrained plan holds the first "
          f"{unconstrained.boundaries[0]:,.0f}\n   arrivals hot (the whole "
          f"reservoir passes through NVMe); C_0={cap0:,} < K\n   clamps the "
          f"hot boundary to {constrained.boundaries[0]:,.0f} docs "
          f"(+${constrained.total - unconstrained.total:.2f} expected cost)")
    return model, constrained, cap0


def slo_example(args):
    print()
    print("=" * 72)
    print("2. archival SLO: S3 Standard -> Glacier Flexible (hours to read)")
    print("=" * 72)
    topo = topology.aws_archive_tiering()
    wl = costs.WorkloadSpec(n_docs=args.n_docs, k=args.k, doc_gb=1e-3,
                            window_months=6.0)
    model = topo.cost_model(wl)
    glacier_lat = model.read_latency[-1]
    print(f"tier read latencies: {model.read_latency.tolist()} s")
    unconstrained = shp.plan_placement_ntier(model)
    fmt_plan("no SLO", model, unconstrained)
    for slo in (glacier_lat / 4, 60.0):
        plan = shp.plan_placement_ntier(
            model, constraints=ConstraintSet(ReadLatencySLO(slo)))
        _, lat = fmt_plan(f"SLO={slo:g}s", model, plan)
        if not lat <= slo * (1 + 1e-9):
            raise SystemExit(f"the plan breaks its {slo:g}s read SLO")
    print("-> the SLO caps the fraction of survivors parked in Glacier; a "
          "tight\n   SLO walks the plan all the way back to S3 Standard")


def reconcile(model, plan, cap0, args):
    """Scaled-down trace replay: the metered occupancy high-water mark must
    respect the capacity the planner was told about."""
    wl = model.workload
    scale = args.sim_docs / wl.n_docs
    k_sim = max(int(wl.k * scale), 8)
    cap_sim = max(int(cap0 * scale), 1)
    sim_model = model.replace(workload=costs.WorkloadSpec(
        n_docs=args.sim_docs, k=k_sim, doc_gb=wl.doc_gb,
        window_months=wl.window_months))
    plan_sim = shp.plan_placement_ntier(
        sim_model, constraints=ConstraintSet(TierCapacity(0, cap_sim)))
    pol = placement.Policy(boundaries=plan_sim.boundaries,
                           migrate_at_r=plan_sim.migrate)
    rng = np.random.default_rng(0)
    cset = ConstraintSet(TierCapacity(0, cap_sim))
    print(f"\ntrace replay (N={args.sim_docs}, K={k_sim}, C_0={cap_sim}, "
          f"{args.trials} trials):")
    worst = np.zeros(sim_model.t, np.int64)
    for _ in range(args.trials):
        res = simulator.simulate(
            simulator.random_rank_trace(args.sim_docs, rng), k_sim, pol,
            sim_model)
        worst = np.maximum(worst, res.occupancy_hwm_per_tier)
        report = res.check_constraints(cset, sim_model)
        if not report["ok"]:
            raise SystemExit(f"constraint violations: {report}")
    print(f"occupancy high-water marks {worst.tolist()} "
          f"(hot cap {cap_sim}) — no violations at reconciliation")
    return worst


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=int(1e7))
    ap.add_argument("--k", type=int, default=int(1e5))
    ap.add_argument("--sim-docs", type=int, default=20_000)
    ap.add_argument("--trials", type=int, default=3)
    return ap.parse_args(argv)


def run(args):
    """The reference's two scenarios and the trace replay, printing its
    lines. Returns a namespace of constrained (the capacity-constrained
    plan) and worst (the replay's occupancy high-water marks per
    tier)."""
    model, constrained, cap0 = capacity_example(args)
    slo_example(args)
    worst = reconcile(model, constrained, cap0, args)
    return SimpleNamespace(constrained=constrained, worst=worst)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
