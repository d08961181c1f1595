"""Three-tier worked example on the PyTorch/CUDA port's host modules: AWS
storage hierarchies under a top-K stream workload. The port of
examples/three_tier_cloud.py, with the same flags and defaults. It runs
on the host (``core.shp``, ``topology``, ``simulator``) and touches no
device, as the reference touches none, so it takes no ``--device``.

The paper's two-tier Algorithm C generalizes to any ordered hierarchy
because the write law E[writes at i] = min(1, K/(i+1)) is non-increasing:
the optimal placement is a non-decreasing boundary vector with one eq.
17/21-style crossover per adjacent tier pair (``core.topology``). This
example

1. plans the flagship 3-tier hierarchy — EFS → S3 Standard → Glacier-IR,
   the paper's case study 2 extended one tier down — in closed form and
   prints the strategy table next to the brute-force grid optimum (a
   genuine 3-boundary migration cascade),
2. shows the S3 Standard → Standard-IA → Glacier-IR lifecycle hierarchy,
   where the validity gate *collapses* the IA tier: its per-request touch
   cost always outweighs its rental advantage, so the optimal cascade
   skips straight from Standard to Glacier,
3. replays a scaled-down trace through ``core.simulator`` with the chosen
   boundary vector and reconciles the per-tier ledger against the analytic
   segment expectations (the §VIII validation, now per tier).

Run: PYTHONPATH=src python examples_torch/three_tier_cloud.py
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np

from repro_torch.core import costs, placement, shp, simulator, topology


def plan_table(model):
    """Print each strategy family's expected cost, paper-table style."""
    rows = []
    for t in range(model.t):
        sc = shp.cost_ntier_no_migration(model,
                                         shp.single_tier_bounds(model, t))
        rows.append((f"all[{model.tier_names[t]}]", sc))
    plan = shp.plan_placement_ntier(model)
    best = plan.best
    rows.append((f"chosen[{plan.strategy}]", best))
    print(f"{'strategy':<34}{'total':>10}  boundaries (b/N)")
    for name, sc in rows:
        bs = ", ".join(f"{b:.4f}" for b in sc.bounds_over_n)
        print(f"{name:<34}{sc.total:>10.2f}  [{bs}]")
    return plan


def reconcile_sim(model, plan, n_sim, trials, seed):
    """Trace-driven validation at reduced scale: same boundary *fractions*,
    per-tier write counts vs the analytic segment expectation."""
    wl = model.workload
    scale = n_sim / wl.n_docs
    k_sim = max(int(wl.k * scale), 8)
    sim_model = model.replace(workload=costs.WorkloadSpec(
        n_docs=n_sim, k=k_sim, doc_gb=wl.doc_gb,
        window_months=wl.window_months))
    bounds = tuple(b * scale for b in plan.boundaries)
    pol = placement.Policy(boundaries=bounds, migrate_at_r=plan.migrate,
                           name=plan.strategy)
    rng = np.random.default_rng(seed)
    writes = np.zeros(model.t)
    totals = []
    for _ in range(trials):
        trace = simulator.random_rank_trace(n_sim, rng)
        res = simulator.simulate(trace, k_sim, pol, sim_model)
        writes += res.writes_per_tier
        # eq. 20 convention: the migration strategy's expected total
        # excludes the final read the simulator meters
        totals.append(res.cost_total - (res.cost_reads if plan.migrate else 0))
    writes /= trials
    edges = np.concatenate([[0.0], bounds, [n_sim]])
    exact = np.diff(np.where(edges > 0,
                             shp.expected_cum_writes(edges - 1.0, k_sim), 0.0))
    print(f"\ntrace-driven validation (N={n_sim}, K={k_sim}, "
          f"{trials} trials):")
    print(f"{'tier':<16}{'sim writes':>12}{'analytic':>12}{'rel err':>10}")
    for t, name in enumerate(model.tier_names):
        err = (writes[t] - exact[t]) / max(exact[t], 1e-12)
        print(f"{name:<16}{writes[t]:>12.1f}{exact[t]:>12.1f}{err:>+10.2%}")
    fn = (shp.cost_ntier_migration if plan.migrate
          else shp.cost_ntier_no_migration)
    expected = fn(sim_model, bounds, exact=True).total
    sim_mean = float(np.mean(totals))
    print(f"cost: simulated ${sim_mean:.4f} vs analytic ${expected:.4f} "
          f"({(sim_mean - expected) / expected:+.2%})")
    return writes, exact


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=int(1e8))
    ap.add_argument("--k", type=int, default=int(1e5))
    ap.add_argument("--doc-mb", type=float, default=1.0)
    ap.add_argument("--window-months", type=float, default=3.0)
    ap.add_argument("--sim-docs", type=int, default=30_000)
    ap.add_argument("--trials", type=int, default=4)
    return ap.parse_args(argv)


def run(args):
    """The three sections of the reference's example, printing its
    lines. Returns a namespace of plan and writes / exact (the
    simulated and analytic per-tier writes)."""
    topo = topology.aws_efs_s3_glacier()
    wl = costs.WorkloadSpec(n_docs=args.n_docs, k=args.k,
                            doc_gb=args.doc_mb * costs.GB_PER_MB,
                            window_months=args.window_months)
    model = topo.cost_model(wl)
    print(f"topology: {' -> '.join(topo.tier_names)}")
    print(f"workload: N={wl.n_docs:.0e} K={wl.k:.0e} doc={args.doc_mb}MB "
          f"window={wl.window_months}mo\n")
    plan = plan_table(model)
    bt, bb, bm = shp.brute_force_plan_ntier(model, grid=64)
    print(f"\nbrute-force grid optimum: ${bt:.2f} at "
          f"[{', '.join(f'{b / wl.n_docs:.4f}' for b in bb)}] "
          f"migrate={bm} (closed form ${plan.total:.2f})")

    ia_topo = topology.aws_s3_tiering()
    ia_plan = shp.plan_placement_ntier(ia_topo.cost_model(wl))
    widths = np.diff([0.0, *ia_plan.boundaries, wl.n_docs]) / wl.n_docs
    print(f"\n{' -> '.join(ia_topo.tier_names)}: {ia_plan.strategy} "
          f"${ia_plan.total:.2f}, tier occupancy "
          f"[{', '.join(f'{w:.4f}' for w in widths)}]")
    print("  (the validity gate collapses Standard-IA: its PUT + retrieval "
          "touch cost\n   outweighs its rental edge, so the cascade skips "
          "straight to Glacier)")
    writes, exact = reconcile_sim(model, plan, args.sim_docs, args.trials,
                                  seed=0)
    return SimpleNamespace(plan=plan, writes=writes, exact=exact)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
