"""Multi-tenant fleet on the PyTorch/CUDA port: 1024+ heterogeneous top-K
streams advanced together in one engine step. The port of
examples/multi_tenant_streams.py, with the same flags and defaults, on
the CUDA card unless ``--device`` names another.

Each tenant stream has its own K, window length and cost model. The fleet
is planned proactively in one vectorized closed-form pass (the paper's r*
per stream, eq. 17/21/22), then every document batch — deliberately
shuffled across tenants — is routed, filtered and merged inside one
engine step (``batched_topk`` on the card). At the end the batched
results are validated bit-for-bit against M independent single-stream
``core.simulator`` replays, and the per-stream ledgers are reconciled
against the analytic write law.

Run (on the card): PYTHONPATH=src python examples_torch/multi_tenant_streams.py
Run (small, on the CPU):
  PYTHONPATH=src python examples_torch/multi_tenant_streams.py \\
      --device cpu --streams 64 --docs 128
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import costs, placement, simulator
from repro_torch.streams import StreamEngine, StreamSpec

K_CHOICES = (4, 8, 16, 32)


def make_fleet(m: int, docs: int, rng: np.random.Generator):
    """Heterogeneous tenant specs: K cycles through K_CHOICES, cost models
    jitter the HBM/host preset so every tenant gets its own r*."""
    specs = []
    for i in range(m):
        k = K_CHOICES[i % len(K_CHOICES)]
        cm = costs.hbm_host_preset(
            n_docs=docs, k=k,
            doc_gb=float(rng.uniform(1e-6, 1e-4)),
            window_seconds=float(rng.uniform(10.0, 600.0)),
            hbm_bw_gbps=819.0,
            host_link_gbps=float(rng.uniform(8.0, 64.0)),
            hbm_capacity_premium=float(rng.uniform(5.0, 500.0)),
        )
        specs.append(StreamSpec(stream_id=i, k=k, cost_model=cm))
    return specs


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=1024)
    ap.add_argument("--docs", type=int, default=256,
                    help="stream/window length per tenant")
    ap.add_argument("--batch", type=int, default=32,
                    help="docs per tenant per engine step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-filter", action="store_true",
                    help="accepted so the reference's command lines run "
                         "unchanged; the port needs no switch: its exact "
                         "buckets take filtered_update (batched_topk on "
                         "the card) whenever a step's width W >= K")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the CUDA "
                         "card; no fallback to the CPU)")
    return ap.parse_args(argv)


def run(args):
    """Plan, ingest, validate and reconcile as the reference's example
    does, printing its lines. Returns a namespace of engine, survivors,
    matched (streams equal to their replay) and ingest_s."""
    dev = device_mod.for_script(args.device)
    rng = np.random.default_rng(args.seed)

    specs = make_fleet(args.streams, args.docs, rng)
    t0 = time.time()
    engine = StreamEngine(specs, device=dev)
    plan = engine.plan  # one vectorized closed-form pass, done in __init__
    print(f"planned {args.streams} streams (and built the engine) in "
          f"{time.time() - t0:.3f}s: {plan.strategy_histogram()}")
    sids = np.array([s.stream_id for s in specs])
    traces = np.stack([simulator.random_rank_trace(args.docs, rng)
                       for _ in range(args.streams)]).astype(np.float32)

    t0 = time.time()
    for t in range(0, args.docs, args.batch):
        w = min(args.batch, args.docs - t)
        mixed_sids = np.repeat(sids, w)
        mixed_dids = np.tile(np.arange(t, t + w), args.streams)
        mixed_scores = traces[:, t:t + w].reshape(-1)
        perm = rng.permutation(mixed_sids.size)  # prove the router works
        engine.ingest(mixed_sids[perm], mixed_scores[perm], mixed_dids[perm])
    dt = time.time() - t0
    total_docs = args.streams * args.docs
    print(f"ingested {total_docs} docs across {args.streams} streams "
          f"in {dt:.2f}s ({total_docs / dt:.0f} docs/s host-to-host)")

    survivors = engine.finalize()

    # --- validate: bit-match M independent single-stream replays ---------
    t0 = time.time()
    mismatches = 0
    for i, spec in enumerate(specs):
        pol = placement.Policy(r=engine.meter.rs[engine.stream_row(i)],
                               migrate_at_r=plan.migrate(i))
        sim = simulator.simulate(traces[i].astype(np.float64), spec.k, pol)
        if not np.array_equal(survivors[i], sim.survivor_ids):
            mismatches += 1
    print(f"validated vs {args.streams} independent core.simulator replays "
          f"in {time.time() - t0:.1f}s: "
          f"bit-match {args.streams - mismatches}/{args.streams}")
    if mismatches:
        raise SystemExit("batched engine diverged from single-stream replays")

    # --- reconcile per-stream ledgers vs the analytic write law ----------
    rec = engine.meter.reconcile(batch=args.batch)
    print(f"ledger reconciliation (batched write law, W={args.batch}): "
          f"fleet writes actual={rec['fleet_actual']:.0f} "
          f"expected={rec['fleet_expected']:.1f} "
          f"mean per-stream rel err={rec['mean_rel_err']:+.3%}")
    n_mig = int(np.sum(engine.meter.migrate))
    print(f"migrating streams: {n_mig} "
          f"(docs bulk-moved A->B: {int(engine.meter.migrations.sum())})")
    show = int(np.argmax(engine.meter.migrations)) if n_mig else 0
    print(f"example per-stream ledger (stream row {show}): "
          f"{engine.meter.ledger(show).as_dict()}")
    return SimpleNamespace(engine=engine, survivors=survivors,
                           matched=args.streams - mismatches, ingest_s=dt)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
