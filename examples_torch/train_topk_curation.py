"""End-to-end script on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps with the paper's top-K tiered curation as a
first-class training feature. The port of examples/train_topk_curation.py,
with the same flags and defaults, on the CUDA card unless ``--device``
names another.

The SHP placement is decided before the run (proactive, closed-form) from
an HBM-host cost model; during the run each train step scores every
example (its per-example NLL) and keeps the device reservoir, while the
host curator places the retained payloads across the hot (device) and
cold (host) tiers, migrating at i = r if the plan says so. Checkpoints are
written asynchronously, and the loop resumes from the newest one after an
interruption. Matrix products run in full float32 (TF32 off).

Run (full, on the card):
    PYTHONPATH=src python examples_torch/train_topk_curation.py
Run (smoke, on the CPU):
    PYTHONPATH=src python examples_torch/train_topk_curation.py \\
        --device cpu --steps 20 --d-model 128 --layers 2 --seq 64 --batch 4
"""
from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig
from repro_torch.core import costs, placement, shp, tiers
from repro_torch.data.curation import TopKCurator
from repro_torch.data.pipeline import StreamLoader
from repro_torch.models import param_count
from repro_torch.runtime import train_loop


def build_cfg(args) -> ModelConfig:
    return ModelConfig(
        name="lm-100m", family="dense", d_model=args.d_model,
        vocab_size=args.vocab,
        layers=(LayerSpec(count=args.layers, mixer="attn", ffn="dense"),),
        n_heads=args.d_model // 64, n_kv_heads=max(args.d_model // 256, 1),
        head_dim=64, d_ff=4 * args.d_model, ffn_act="silu_glu",
        tie_embeddings=True,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reservoir-k", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="artifacts/e2e_ckpt")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the CUDA card; "
                         "no fallback to the CPU)")
    return ap.parse_args(argv)


def setup(args, device):
    """The proactive SHP plan for the curation payload stream, its policy,
    the tiered store (the hot tier on ``device``) and the curator:
    (plan, policy, store, curator)."""
    n_docs = args.steps * args.batch
    doc_gb = args.seq * 4 / 1e9  # one example's tokens
    cm = costs.hbm_host_preset(n_docs=n_docs, k=args.reservoir_k,
                               doc_gb=doc_gb, window_seconds=3600.0)
    plan = shp.plan_placement(cm)
    pol = placement.from_plan(plan)
    store = tiers.TieredStore(
        pol, tiers.HotTier(args.reservoir_k, (args.seq,), dtype=torch.int32,
                           device=device),
        tiers.ColdTier())
    curator = TopKCurator(args.reservoir_k, store, policy=pol)
    return plan, pol, store, curator


def run(args, curator_wrapper=None):
    """Train as the reference's example does and print its lines.
    ``curator_wrapper``, when given, wraps the curator the loop feeds (an
    object with its ``observe_batch``). Returns a namespace of cfg, loader,
    plan, policy, store, curator, report (train_loop's), seconds and
    hardest (the retained payloads by id)."""
    dev = device_mod.for_script(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = build_cfg(args)
    print(f"model: {param_count(cfg)/1e6:.1f}M params on {dev}")
    shape = ShapeConfig("e2e", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    loader = StreamLoader(cfg, shape, seed=0)

    # ---- proactive SHP plan for the curation payload stream -----------
    n_docs = args.steps * args.batch
    plan, pol, store, curator = setup(args, dev)
    writes = shp.expected_cum_writes(n_docs - 1, args.reservoir_k)
    print(f"SHP plan: {plan.strategy} r*/N={plan.best.r_over_n:.3f} "
          f"(writes are {writes:.0f} of {n_docs} docs)")

    ckpt = CheckpointManager(args.ckpt_dir, keep_latest=2, keep_best=2)
    t0 = time.time()
    report = train_loop.run(
        cfg, loader, loop=train_loop.LoopConfig(
            total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
            log_every=max(args.steps // 20, 1), lr=args.lr),
        ckpt=ckpt, curator=curator_wrapper(curator) if curator_wrapper
        else curator, device=dev,
        on_metrics=lambda s, m: print(
            f"  step {s:4d} loss {m['loss']:.3f} "
            f"({m['step_time']*1000:.0f} ms)", flush=True))
    dt = time.time() - t0

    print(f"\ntrained {report.steps_run} steps in {dt:.0f}s "
          f"(resumed_from={report.resumed_from})")
    if report.losses:
        print(f"loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    print(f"curation: {curator.stats.as_dict()}")
    print(f"analytic E[writes]: {curator.expected_writes():.1f}")
    print(f"tier ledger: {store.ledger.as_dict()}")
    hardest = curator.finalize()
    print(f"top-{args.reservoir_k} hardest examples retained "
          f"(ids {sorted(hardest)[:6]} ...) — ready for HITL reanalysis")
    return SimpleNamespace(cfg=cfg, loader=loader, plan=plan, policy=pol,
                           store=store, curator=curator, report=report,
                           seconds=dt, hardest=hardest)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
