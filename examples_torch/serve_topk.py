"""Serving on the PyTorch/CUDA port: batched prefill + decode with top-K
request logging. The port of examples/serve_topk.py, with the same flags
and defaults, on the CUDA card unless ``--device`` names another.

A small LM (the reduced config of ``--arch``) serves batches of
requests; every completed request is scored by predictive entropy
(uncertainty), and the top-K most "interesting" requests per window are
retained in tiered storage (hot slab on the device → cold host store) at
the placement the SHP plan chose — the paper's workflow with the serving
fleet as the producer and offline analysis as the consumer. The loop is
``repro_torch.launch.serve.serve``: on the card the prefill's attention
is the ``flash_attention`` kernel and each decode step's entropy the
``entropy_scores`` kernel.

Multi-tenant mode (``--tenants M``): requests are interleaved across M
tenant streams, each with its own K, cost model and tier topology (every
third tenant places across a 3-tier HBM → DRAM → disk hierarchy, the rest
across the 2-tier HBM → host preset); retention then runs through the
batched ``repro_torch.streams`` engine (``launch.serve.make_tenant_engine``).

``--mesh N`` shards the tenant fleet axis over a ``FleetMesh`` of N
shards: N cards when N are visible, else N shards on ``--device``.
``--obs-out``, ``--obs-port``, ``--obs-hold``, ``--ckpt-dir`` and
``--ckpt-every`` are the launcher's (``python -m
repro_torch.launch.serve``), as the reference's example shares them with
its launcher.

Run (on the card): PYTHONPATH=src python examples_torch/serve_topk.py
Run (small, on the CPU):
  PYTHONPATH=src python examples_torch/serve_topk.py --device cpu \\
      --requests 16 --batch 4 --gen-len 12 [--tenants 4]
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=1,
                    help="number of tenant streams; with >1, retention is "
                         "routed through the multi-tenant streams engine "
                         "(heterogeneous per-tenant K, cost model, and "
                         "tier depth — every third tenant plans a 3-tier "
                         "HBM->DRAM->disk hierarchy); requires "
                         "--requests >= 2*tenants")
    ap.add_argument("--obs-out", default=None, metavar="DIR",
                    help="enable the repro_torch.obs telemetry layer and "
                         "write metrics.json / metrics.prom (Prometheus "
                         "text exposition) / events.jsonl artifacts to DIR")
    ap.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                    help="serve live /metrics (Prometheus) and /snapshot "
                         "(JSON) from the running engine on this port "
                         "(0 = ephemeral); implies the obs layer with "
                         "cost attribution on")
    ap.add_argument("--obs-hold", type=float, default=0.0, metavar="SEC",
                    help="stretch the serving loop over at least SEC "
                         "seconds so a scraper can observe the live "
                         "counters advancing")
    ap.add_argument("--mesh", type=int, default=1,
                    help="shard the tenant fleet axis over N shards: N "
                         "cards when N are visible, else N shards on "
                         "--device; requires --tenants > 1")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="crash-consistent fleet checkpointing "
                         "(repro_torch.resilience; requires --tenants > "
                         "1): write chunk-boundary checkpoints to DIR, "
                         "plus a final blocking checkpoint on exit and on "
                         "SIGTERM/SIGINT")
    ap.add_argument("--ckpt-every", type=int, default=4, metavar="N",
                    help="checkpoint every N ingested chunks (0 = final "
                         "checkpoint only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the CUDA "
                         "card; no fallback to the CPU)")
    return ap.parse_args(argv)


def run(args):
    """Serve as the reference's example does and print its lines. Returns
    a namespace of res (``launch.serve.ServeResult``: scores, tokens,
    retained, the curator and store or the engine and specs)."""
    launch_serve.check_flags(args)
    dev = device_mod.for_script(args.device)
    mesh, obs, obs_server = launch_serve.setup(args, dev)
    with launch_serve.graceful_stop(obs_server) as stop:
        cfg = configs.get_config(args.arch, reduced=True)
        params = lm.init_params(cfg, seed=0, device=dev)
        print(f"serving reduced {args.arch}: vocab={cfg.vocab_size}")

        doc_gb = (args.prompt_len + args.gen_len) * 4 / 1e9
        engine = specs = None
        if args.tenants > 1:
            if args.requests // args.tenants < 2:
                raise SystemExit(f"need requests >= 2*tenants, got "
                                 f"{args.requests} requests for "
                                 f"{args.tenants} tenants")
            engine, specs = launch_serve.make_tenant_engine(
                args.tenants, args.requests, args.topk, doc_gb, device=dev,
                obs=obs, mesh=mesh)
            print(f"multi-tenant retention: {args.tenants} streams, "
                  f"fleet plan {engine.plan.strategy_histogram()}")
        else:
            plan = launch_serve.request_log_plan(args.requests, args.topk,
                                                 doc_gb)
            print(f"SHP plan for request log: {plan.strategy} "
                  f"r*/N={plan.best.r_over_n:.3f}")
        if args.ckpt_dir is not None:
            print(f"checkpointing to {args.ckpt_dir} "
                  f"(every {args.ckpt_every} chunks)")
        res = launch_serve.serve(
            cfg, params, requests=args.requests, batch=args.batch,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            topk=args.topk, tenants=args.tenants, device=dev, obs=obs,
            hold_s=args.obs_hold, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            stop=lambda: stop["signal"] is not None, mesh=mesh,
            engine=engine, specs=specs)
        launch_serve.report(args, res, obs, stop)
    return SimpleNamespace(res=res)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
