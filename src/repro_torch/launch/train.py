"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` — the port of the reference's ``launch.train``.

Runs the fault-tolerant loop (auto-resume, SIGTERM-safe, straggler
watchdog) with top-K tiered curation for the architectures the port runs,
on the CUDA card unless ``--device`` names another. ``--reduced`` takes
the reduced config. Matrix products run in full float32 (TF32 off for
CUDA matmuls and cuDNN).

A SIGTERM or SIGINT stops the loop at the next step boundary; the final
checkpoint is written and the last line names the step it holds.

Run: PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b
     --reduced --steps 50 [--ckpt-dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costs, placement, shp, tiers
from repro_torch.data.curation import TopKCurator
from repro_torch.data.pipeline import StreamLoader
from repro_torch.models import param_count
from repro_torch.runtime import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (a smoke-test size)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reservoir-k", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    print(f"{args.arch}: {param_count(cfg)/1e6:.1f}M params "
          f"({'reduced' if args.reduced else 'FULL'}) on {dev}")
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    loader = StreamLoader(cfg, shape, seed=0)

    n_docs = args.steps * args.batch
    k = min(args.reservoir_k, max(n_docs // 4, 1))
    args.reservoir_k = k
    cm = costs.hbm_host_preset(n_docs=n_docs, k=k,
                               doc_gb=args.seq * 4 / 1e9,
                               window_seconds=3600.0)
    plan = shp.plan_placement(cm)
    pol = placement.from_plan(plan)
    print(f"SHP curation plan: {plan.strategy} r*/N={plan.best.r_over_n:.3f}")
    store = tiers.TieredStore(
        pol, tiers.HotTier(args.reservoir_k, (args.seq,), dtype=torch.int32,
                           device=dev),
        tiers.ColdTier())
    curator = TopKCurator(args.reservoir_k, store, policy=pol)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    report = train_loop.run(
        cfg, loader, loop=train_loop.LoopConfig(
            total_steps=args.steps, ckpt_every=max(args.steps // 2, 1),
            log_every=max(args.steps // 10, 1), lr=args.lr),
        ckpt=ckpt, curator=curator, device=dev,
        on_metrics=lambda s, m: print(f"  step {s} loss {m['loss']:.3f}",
                                      flush=True))
    if report.losses:
        print(f"done: loss {report.losses[0]:.3f} -> "
              f"{report.losses[-1]:.3f}; curation "
              f"{curator.stats.as_dict()}")
    step = int(report.final_state.step)
    how = "stopped by a signal" if report.interrupted else "finished"
    saved = f"; final checkpoint at step {step}" if ckpt is not None else ""
    print(f"{how} at step {step} ({report.steps_run} steps run, resumed "
          f"from {report.resumed_from}){saved}", flush=True)


if __name__ == "__main__":
    main()
