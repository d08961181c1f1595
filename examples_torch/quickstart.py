"""Quickstart on the PyTorch/CUDA port: the paper's optimization end to
end in a minute. The port of examples/quickstart.py; its training runs on
the CUDA card unless ``--device`` names another.

1. Build a two-tier cost model (Table I prices).
2. Get the closed-form placement plan (r*, strategy) — eqs. 17/21/22.
3. Validate it against a trace-driven simulation.
4. Run a tiny LM train loop (reduced llama3.2-1b, 20 ``train_step``s;
   on the card its attention is the ``flash_attention`` kernel, forward
   and backward) where the top-K most interesting examples are retained
   across a hot/cold TieredStore under that plan.

Run (on the card): PYTHONPATH=src python examples_torch/quickstart.py
Run (on the CPU):
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costs, placement, shp, simulator, tiers
from repro_torch.data.curation import TopKCurator
from repro_torch.data.pipeline import StreamLoader
from repro_torch.runtime import steps as steps_mod


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the CUDA card; "
                         "no fallback to the CPU)")
    return ap.parse_args(argv)


def run(args, state=None):
    """The reference's four sections, printing its lines. ``state`` (a
    ``runtime.steps.TrainState`` on ``--device``) replaces the seeded
    initial train state. Returns a namespace of plan, sim (the
    trace-driven validation), analytic, curator, store, ids and nll
    (each step's example ids and per-example NLL, as numpy), same
    (device reservoir == host curator) and hard (the retained payloads
    by id)."""
    dev = device_mod.for_script(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # ---- 1-2: analytic plan -------------------------------------------
    cm = costs.case_study_1()
    plan = shp.plan_placement(cm)
    print("== Case study 1 (AWS S3 -> Azure Blob) ==")
    print(f"  strategy: {plan.strategy}")
    print(f"  r*/N    : {plan.best.r_over_n:.4f} (paper: 0.41233169)")
    print(f"  E[cost] : ${plan.best.total:.2f} (paper: 35.19)")
    for c in plan.candidates:
        print(f"    candidate {c.strategy:28s} ${c.total:8.2f}")

    # ---- 3: trace-driven validation (paper Fig. 8) --------------------
    n, k = 50_000, 500
    small = cm.replace(workload=costs.WorkloadSpec(
        n_docs=n, k=k, doc_gb=cm.workload.doc_gb,
        window_months=cm.workload.window_months))
    pol = placement.optimal_policy(small)
    rng = np.random.default_rng(0)
    sim = simulator.simulate(simulator.grn_entropy_trace(n, rng), k, pol,
                             small, storage_bound=True)
    analytic = shp.cost_no_migration(small, pol.r, exact=True).total
    print("\n== Trace-driven validation ==")
    print(f"  simulated cost ${sim.cost_total:.4f} vs analytic "
          f"${analytic:.4f}")
    print(f"  writes A/B: {sim.writes_per_tier.tolist()}  "
          f"evictions: {sim.evictions}")

    # ---- 4: top-K curation inside a (tiny) train loop ------------------
    print("\n== Top-K curation during training ==")
    cfg = configs.get_config("llama3.2-1b", reduced=True)
    shape = ShapeConfig("quick", seq_len=32, global_batch=8, kind="train")
    loader = StreamLoader(cfg, shape, seed=0)
    kq = 16
    total = 20 * shape.global_batch
    store = tiers.TieredStore(placement.Policy(r=total // 2),
                              tiers.HotTier(kq, (shape.seq_len,),
                                            dtype=torch.int32, device=dev),
                              tiers.ColdTier())
    cur = TopKCurator(kq, store, policy=store.policy)
    if state is None:
        state = steps_mod.init_train_state(cfg, seed=0, reservoir_k=kq,
                                           device=dev)
    seen_ids, seen_nll = [], []
    for step in range(20):
        batch = {name: torch.as_tensor(v, device=dev)
                 for name, v in loader.batch_for_step(step).items()}
        state, metrics = steps_mod.train_step(state, batch, cfg)
        ids = batch["example_ids"].cpu().numpy()
        nll = metrics["per_example_nll"].cpu().numpy()
        seen_ids.append(ids)
        seen_nll.append(nll)
        cur.observe_batch(ids, nll, batch["tokens"].cpu().numpy())
    print(f"  observed {cur.stats.observed} examples; "
          f"writes {cur.stats.writes} "
          f"(analytic E[writes] {cur.expected_writes():.1f})")
    same = (sorted(int(i) for i in state.reservoir.ids.cpu().numpy())
            == sorted(cur.survivor_ids().tolist()))
    print(f"  device reservoir == host curator: {same}")
    hard = cur.finalize()
    print(f"  retained top-{kq} hardest examples: {sorted(hard)[:8]} ...")
    print(f"  tier ledger: {store.ledger.as_dict()}")
    return SimpleNamespace(plan=plan, sim=sim, analytic=analytic,
                           curator=cur, store=store, ids=seen_ids,
                           nll=seen_nll, same=same, hard=hard)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
