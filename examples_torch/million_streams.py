"""Million-stream sharded serving on the PyTorch/CUDA port: plan, ingest,
finalize one top-K retention window for 1M tenant streams with the fleet
axis split into shards. The port of examples/million_streams.py, with the
same flags and defaults, on the CUDA card unless ``--device`` names
another.

1. **Plan** — one candidate-grid solve over all M streams' 3-tier cost
   arrays through ``core.shp.plan_ntier_arrays`` (its "auto" rule takes
   the device planner, the ``plan_solve`` kernel, on the card, and the
   NumPy solver on the CPU), then water-filling of a fleet-shared
   hot-tier budget (``streams.planner.waterfill``: a bisection over the
   shards under a mesh) and a constrained re-solve of only the streams
   the budget binds.
2. **Ingest** — a ``StreamEngine`` over the mesh: reservoirs, metrics
   and the logmem state live on the device, split by rows; chunks stream
   through the double-buffered ``ingest_chunks`` loop (``batched_topk``
   for the exact streams, ``logmem_update`` for the huge-K ones).
3. **Finalize** — the final top-K reads metered per stream; the obs
   snapshot reports the fleet's counters summed over the shards.

Beside the million small-K exact reservoirs the window co-runs a pack of
huge-K ``engine="logmem"`` tenants (K = 65536 by default), with the admit
counts held to the closed-form write law within the backend's
1 - O(1/sqrt K) slack and the bytes-per-stream advantage checked >= 8x.

``--devices N`` builds a ``parallel.fleet.FleetMesh`` of N shards: on N
cards when N are visible, else N shards on the engine's device (the
reference forces N host devices instead). ``--devices 1`` runs the same
window unsharded.

Run (on the card):
  PYTHONPATH=src python examples_torch/million_streams.py [--streams 1000000]
  PYTHONPATH=src python examples_torch/million_streams.py --ci  # 64k
Run (small, on the CPU):
  PYTHONPATH=src python examples_torch/million_streams.py --device cpu \\
      --devices 2 --streams 2000 --docs 64 --logmem-streams 4 \\
      --logmem-k 256 --logmem-chunk 512
"""
from __future__ import annotations

import argparse
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import constraints as cons
from repro_torch.core import shp
from repro_torch.obs import Observability, ObsConfig
from repro_torch.parallel import fleet
from repro_torch.streams import StreamEngine, StreamSpec, logmem, planner


def fleet_cost_arrays(rng, m, n_docs, k):
    """Per-stream 3-tier (hot/warm/cold) cost arrays: write-cheap
    read-expensive hot tier, the reverse cold, jittered per stream so
    the fleet plan is genuinely heterogeneous."""
    jit = lambda lo, hi: rng.uniform(lo, hi, m)  # noqa: E731
    cw = np.stack([jit(0.8, 1.2) * 1e-6, jit(0.8, 1.2) * 2e-5,
                   jit(0.8, 1.2) * 8e-5], axis=1)
    cr = np.stack([jit(0.8, 1.2) * 2.7e-4, jit(0.8, 1.2) * 4e-5,
                   jit(0.8, 1.2) * 1e-6], axis=1)
    cs = np.stack([jit(0.8, 1.2) * 2.5e-6, jit(0.8, 1.2) * 1e-6,
                   jit(0.8, 1.2) * 2.5e-7], axis=1)
    n = np.full(m, float(n_docs))
    kv = np.full(m, float(k))
    rpw = rng.uniform(0.5, 4.0, m)
    return cw, cr, cs, n, kv, rpw


def plan_phase(mesh, rng, m, n_docs, k, hot_frac, device):
    """Fleet plan + shared hot-tier water-filling. Besides the merged
    bounds and migrate flags and the stats, returns the cost arrays, the
    first solve, the binding rows, their caps and their re-solve."""
    args = fleet_cost_arrays(rng, m, n_docs, k)
    cw, cr, cs, n, kv, rpw = args
    t0 = time.time()
    with fleet.use_fleet_mesh(mesh):
        plan = shp.plan_ntier_arrays(*args, device=device)
    t_solve = time.time() - t0
    bounds, mig = plan["bounds"], plan["migrate"]
    desired = cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0]
    budget = float(desired.sum()) * hot_frac
    t0 = time.time()
    grants = planner.waterfill(desired, budget, mesh=mesh)
    t_wf = time.time() - t0
    binding = grants < desired - 1e-9
    idx = np.flatnonzero(binding)
    cap = re = None
    t0 = time.time()
    if binding.any():
        cap = np.full((idx.size, 3), np.inf)
        cap[:, 0] = grants[idx]
        with fleet.use_fleet_mesh(mesh):
            re = shp.plan_ntier_arrays(*(a[idx] for a in args), cap=cap,
                                       device=device)
        bounds = bounds.copy()
        mig = mig.copy()
        bounds[idx] = re["bounds"]
        mig[idx] = re["migrate"]
    t_resolve = time.time() - t0
    hot_occ = cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0]
    if not hot_occ.sum() <= budget * (1 + 1e-9) + 1e-6:
        raise SystemExit("hot-tier budget oversubscribed after re-solve")
    return {
        "bounds": bounds, "migrate": mig,
        "stats": {
            "solve_s": round(t_solve, 3),
            "waterfill_s": round(t_wf, 3),
            "resolve_s": round(t_resolve, 3),
            "binding_streams": int(binding.sum()),
            "hot_budget_docs": budget,
            "hot_peak_docs": float(hot_occ.sum()),
        },
        "args": args, "solve": plan, "grants": grants, "idx": idx,
        "cap": cap, "resolve": re,
    }


def dense_chunks(rng, m, w, n_chunks, lm=0, lw=0):
    """Generator of ingest_dense-shaped chunks: the main uniform-K exact
    bucket, plus (when ``lm`` > 0) a second pair for the huge-K logmem
    bucket — wider chunks, so the big-K tenants get past their admit-all
    warmup inside the same window. Produced lazily so chunk t+1's
    materialization and host→device copy overlap chunk t's step."""
    for c in range(n_chunks):
        sc = rng.standard_normal((m, w)).astype(np.float32)
        ids = np.tile(np.arange(c * w, (c + 1) * w, dtype=np.int32),
                      (m, 1))
        pairs = [(sc, ids)]
        if lm:
            ls = rng.standard_normal((lm, lw)).astype(np.float32)
            lids = np.tile(np.arange(c * lw, (c + 1) * lw, dtype=np.int32),
                           (lm, 1))
            pairs.append((ls, lids))
        yield pairs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="fleet-axis shards: N cards when N are visible, "
                         "else N shards on --device; 1 runs unsharded")
    ap.add_argument("--streams", type=int, default=1_000_000)
    ap.add_argument("--docs", type=int, default=256,
                    help="docs per stream in the window")
    ap.add_argument("--chunk", type=int, default=16,
                    help="docs per stream per ingest chunk")
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--hot-frac", type=float, default=0.6,
                    help="fleet-shared hot-tier budget as a fraction of "
                         "the unconstrained plan's hot occupancy")
    ap.add_argument("--meter", action="store_true",
                    help="keep the per-stream host ledgers during ingest "
                         "(the default is pure-throughput: device metrics "
                         "only, ledgers at finalize)")
    ap.add_argument("--logmem-streams", type=int, default=None,
                    help="huge-K O(log K) tenants co-run beside the main "
                         "fleet (default: 64 under --ci, else 0)")
    ap.add_argument("--logmem-k", type=int, default=65_536,
                    help="reservoir width of the logmem tenants")
    ap.add_argument("--logmem-chunk", type=int, default=8_192,
                    help="docs per logmem stream per ingest chunk")
    ap.add_argument("--ci", action="store_true",
                    help="CI scale: 64k streams + 64 K=65536 logmem "
                         "tenants")
    ap.add_argument("--out", default="bench_out/million_streams.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and the planner "
                         "(default: the CUDA card; no fallback to the CPU)")
    return ap.parse_args(argv)


def make_mesh(shards, dev):
    """A FleetMesh of ``shards`` shards (None below 2): on that many
    cards when they are visible, else all on ``dev``."""
    if shards <= 1:
        return None
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= shards:
        return fleet.fleet_mesh(shards)
    return fleet.fleet_mesh(shards, device=dev)


def run(args):
    """Plan, ingest and finalize one window as the reference's example
    does, print its lines and write ``--out``. Returns a namespace of the
    mesh, plan (``plan_phase``'s dict), engine, done (chunks), snapshot,
    lm_stats and out (the JSON written)."""
    dev = device_mod.for_script(args.device)
    if args.ci:
        args.streams = min(args.streams, 64_000)
    lm = (args.logmem_streams if args.logmem_streams is not None
          else (64 if args.ci else 0))
    lk, lw = args.logmem_k, args.logmem_chunk

    mesh = make_mesh(args.devices, dev)
    shards = fleet.n_shards(mesh)
    n_devices = 1 if mesh is None else len(set(mesh.devices))
    m, k = args.streams, args.topk
    if lm and lm % max(shards, 1):
        lm = (-(-lm // shards)) * shards  # keep the logmem bucket even
    print(f"{m} streams on {n_devices} devices "
          f"({shards} shards)"
          + (f" + {lm} logmem tenants at K={lk}" if lm else ""))
    rng = np.random.default_rng(0)

    # --- phase 1: plan + cross-shard water-filling -----------------------
    plan = plan_phase(mesh, rng, m, args.docs, k, args.hot_frac, dev)
    st = plan["stats"]
    print(f"plan: solve {st['solve_s']}s, waterfill {st['waterfill_s']}s, "
          f"re-solve of {st['binding_streams']} binding streams "
          f"{st['resolve_s']}s; hot occupancy {st['hot_peak_docs']:.0f} "
          f"<= budget {st['hot_budget_docs']:.0f}")

    # --- phase 2: sharded double-buffered ingest -------------------------
    t0 = time.time()
    specs = [StreamSpec(stream_id=i, k=k, boundaries=bt, migrate=bool(mg))
             for i, (bt, mg) in enumerate(zip(
                 map(tuple, plan["bounds"].tolist()), plan["migrate"]))]
    # huge-K tenants: O(log K) device state, admission by threshold
    # compare — the same fleet step advances both buckets
    specs += [StreamSpec(stream_id=m + i, k=lk, r=float(4 * lk),
                         engine="logmem") for i in range(lm)]
    obs = Observability(ObsConfig(residuals=False))
    eng = StreamEngine(specs, obs=obs, mesh=mesh, device=dev)
    t_build = time.time() - t0
    n_chunks = args.docs // args.chunk
    t0 = time.time()
    done = eng.ingest_chunks(
        dense_chunks(rng, m, args.chunk, n_chunks, lm, lw),
        meter=args.meter)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_ingest = time.time() - t0
    docs = (m * args.chunk + lm * lw) * done
    print(f"ingest: {done} chunks, {docs / 1e6:.1f}M docs in "
          f"{t_ingest:.2f}s ({docs / t_ingest / 1e6:.2f}M docs/s)")

    # --- phase 3: finalize + fleet-global obs ----------------------------
    t0 = time.time()
    states = eng.states()
    for bi, b in enumerate(eng.buckets):
        if b.engine == "logmem":
            continue  # no device-resident ids to read back
        eng.meter.record_reads(eng._global_rows[bi],
                               states[bi].ids.cpu().numpy())
    t_final = time.time() - t0
    snap = eng.obs_snapshot()
    em = snap["engine"]
    if em["docs"] != docs:
        raise SystemExit(f"obs counted {em['docs']} docs, not {docs}")
    if int(eng.meter.reads.sum()) != m * k:
        raise SystemExit("final reads are not M * K")
    print(f"finalize: {t_final:.2f}s; fleet-global obs: "
          f"docs={em['docs']} admits={em['admits']} "
          f"evictions={em['evictions']} chunks={em['chunks']}")

    lm_stats = None
    if lm:
        lb = next(bi for bi, b in enumerate(eng.buckets)
                  if b.engine == "logmem")
        admits = states[lb].admits.cpu().numpy().astype(np.float64)[:lm]
        n_lm = lw * done
        law = float(logmem.expected_admits(np.asarray([n_lm]), lk)[0])
        slack = logmem.law_slack(lk)
        admit_ratio = float(admits.mean()) / law
        bps = logmem.state_bytes_per_stream(states[lb])
        exact_bps = logmem.exact_bytes_per_stream(lk)
        if not abs(admit_ratio - 1.0) <= 3.0 * slack:
            raise SystemExit(f"logmem admits {admit_ratio:.4f}x law, beyond "
                             f"the {3.0 * slack:.4f} slack budget")
        if not exact_bps / bps >= 8.0:
            raise SystemExit(f"logmem state {bps} B/stream is not 8x leaner "
                             f"than {exact_bps}")
        lm_stats = {
            "streams": lm, "k": lk, "docs_per_stream": n_lm,
            "admits_mean": float(admits.mean()),
            "expected_admits": law,
            "admit_ratio": round(admit_ratio, 5),
            "law_slack": round(slack, 5),
            "bytes_per_stream": round(bps, 1),
            "exact_bytes_per_stream": exact_bps,
            "memory_ratio": round(exact_bps / bps, 1),
        }
        print(f"logmem: {lm} tenants at K={lk}: admits "
              f"{admit_ratio:.4f}x law (slack {slack:.4f}), "
              f"{bps:.0f} B/stream vs {exact_bps:.0f} exact "
              f"({exact_bps / bps:.0f}x leaner)")

    out = {
        "streams": m, "devices": n_devices,
        "shards": shards, "docs_per_stream": args.docs,
        "chunk": args.chunk, "topk": k,
        "plan": st,
        "engine_build_s": round(t_build, 3),
        "ingest_s": round(t_ingest, 3),
        "ingest_docs_per_s": round(docs / t_ingest, 1),
        "finalize_s": round(t_final, 3),
        "obs_engine": em,
        "meter": snap["meter"],
        "logmem": lm_stats,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}")
    return SimpleNamespace(mesh=mesh, plan=plan, engine=eng, done=done,
                           snapshot=snap, lm_stats=lm_stats, out=out)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
