"""Chaos drill on the PyTorch/CUDA port: kill -9 mid-window, restore,
resume — bitwise — then survive a tier outage and print the regret
table. The port of examples/chaos_recovery.py, with the same flags and
defaults, on the CUDA card unless ``--device`` names another (the child
process gets the same ``--device``).

Phase 1 (crash recovery): a child process ingests the fleet with
chunk-boundary checkpointing on and SIGKILLs *itself* at a seeded chunk
that is not a checkpoint boundary (the worst case: the cursor is past
the last committed save, an async write may be mid-flight). The parent
then restores the latest committed checkpoint onto a freshly built
engine, replays the remaining chunks, and checks that the final
reservoirs and every host ledger are bitwise identical to an
uninterrupted reference run (sha256 digests printed for both).

Phase 2 (tier outage): the recovered engine keeps serving; mid-window
the DRAM tier is declared failed — affected tenants are evacuated
through the constrained suffix re-solve (the failed tier masked from
the feasible set), ingest continues with the tier empty, and recovery
re-admits it after hysteresis. The evacuation bill is credited to the
planned trajectory, so the closing per-tenant regret table
(``online.evaluate.regret_table``) charges the outage to the operator,
not the tenants — and no budget-burn alert false-fires.

Artifacts: the checkpoint directory and the streamed obs event log
(checkpoint / tier_outage / tier_evacuation / tier_recovered events)
are left on disk.

Run (on the card):
  PYTHONPATH=src python examples_torch/chaos_recovery.py [--out chaos_out]
Run (small, on the CPU):
  PYTHONPATH=src python examples_torch/chaos_recovery.py --device cpu \\
      --tenants 4 --ckpt-dir /tmp/chaos_ckpt --out /tmp/chaos_out
"""
from __future__ import annotations

import argparse
import hashlib
import os
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import topology
from repro_torch.obs import Observability, ObsConfig
from repro_torch.online import DriftConfig, ReplanConfig, evaluate
from repro_torch.resilience import FleetCheckpointer, TierOutage
from repro_torch.streams.engine import StreamEngine, StreamSpec

W = 32  # docs per tenant per chunk


def build_engine(tenants, total_docs, k, events_path=None, device=None):
    """The drill fleet: 3-tier (HBM -> DRAM -> disk) tenants — half
    planner-placed from their cost models, half pinned to explicit
    boundaries whose DRAM band spans the window (so the outage has
    residents AND future arrivals to move) — with drift-driven
    re-planning and cost attribution on: the full state surface a
    checkpoint must carry."""
    specs = []
    for t in range(tenants):
        cm = topology.hbm_dram_disk_preset(
            n_docs=total_docs, k=k, doc_gb=1e-4,
            window_seconds=30.0 * (1 + t % 3))
        if t % 2:  # pinned, but still priced by the model
            specs.append(StreamSpec(stream_id=t, k=k, cost_model=cm,
                                    boundaries=(32.0, total_docs * 0.8)))
        else:
            specs.append(StreamSpec(stream_id=t, k=k, cost_model=cm))
    obs = Observability(ObsConfig(costs=True, events_path=events_path))
    return StreamEngine(specs, obs=obs,
                        replan=ReplanConfig(drift=DriftConfig(alpha=0.05)),
                        device=device)


def make_chunk(engine, i, seed):
    """Chunk ``i`` as a pure function of its index (the crash replays
    chunks from their index; determinism is the whole game)."""
    r = np.random.default_rng(seed + i)
    dense = []
    for b in engine.buckets:
        s = r.random((b.m, W)).astype(np.float32)
        if i >= 4:  # mid-window heat-up so the drift/replan path runs
            s[: b.m // 2] += 0.5
        ids = np.tile(np.arange(i * W, (i + 1) * W, dtype=np.int32),
                      (b.m, 1))
        dense.append((s, ids))
    return dense


def digest(engine) -> str:
    """sha256 over the survivors and every host ledger — the bitwise
    acceptance check collapsed to one line."""
    h = hashlib.sha256()
    for sid in sorted(engine.finalize()):
        h.update(np.ascontiguousarray(engine.finalize()[sid]))
    for name, arr in sorted(engine.meter.state_dict().items()):
        h.update(np.ascontiguousarray(arr))
    if engine._cost_monitor is not None:
        for name, arr in sorted(engine._cost_monitor.state_dict().items()):
            h.update(np.ascontiguousarray(np.asarray(arr)))
    return h.hexdigest()


def child(args):
    """Ingest with checkpointing on; SIGKILL ourselves mid-window."""
    eng = build_engine(args.tenants, args.total_docs, args.k,
                       events_path=os.path.join(args.out,
                                                "child_events.jsonl"),
                       device=device_mod.for_script(args.device))
    ck = FleetCheckpointer(args.ckpt_dir, every=args.ckpt_every)
    eng.attach_checkpointer(ck)
    for i in range(args.chunks):
        eng.ingest_dense(make_chunk(eng, i, args.seed))
        if i == args.kill_at:
            # kill -9: no atexit, no flush, an async npy write possibly
            # mid-flight — exactly what the atomic rename must survive
            os.kill(os.getpid(), signal.SIGKILL)
    raise SystemExit("child was supposed to die")  # pragma: no cover


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--chunks", type=int, default=12)
    ap.add_argument("--extra-chunks", type=int, default=6,
                    help="chunks served through the tier-outage phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-at", type=int, default=7,
                    help="seeded chunk index at which the child SIGKILLs "
                         "itself (chosen off the checkpoint cadence so "
                         "restore must replay)")
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="chaos_ckpt")
    ap.add_argument("--out", default="chaos_out")
    ap.add_argument("--role", default="parent", choices=["parent", "child"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines, the child's too "
                         "(default: the CUDA card; no fallback to the CPU)")
    return ap.parse_args(argv)


def run(args):
    """The drill as the reference's example runs it, printing its lines:
    the uninterrupted run, the child killed -9 and the restore and replay
    (digests equal), the tier outage and the regret table. Returns a
    namespace of ref (the uninterrupted engine), ref_digest, rec_digest,
    child_rc, cursor (the restored checkpoint's chunk) and resilience
    (the recovered engine's snapshot section)."""
    dev = device_mod.for_script(args.device)
    args.total_docs = (args.chunks + args.extra_chunks) * W
    os.makedirs(args.out, exist_ok=True)
    if args.role == "child":
        child(args)
        return None

    # ---- reference: the uninterrupted run ------------------------------
    ref = build_engine(args.tenants, args.total_docs, args.k, device=dev)
    for i in range(args.chunks):
        ref.ingest_dense(make_chunk(ref, i, args.seed))
    ref_digest = digest(ref)
    print(f"reference: {args.chunks} chunks, digest {ref_digest[:16]}…")

    # ---- phase 1: kill -9 mid-window, restore, replay ------------------
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--role", "child",
         "--tenants", str(args.tenants), "--k", str(args.k),
         "--chunks", str(args.chunks),
         "--extra-chunks", str(args.extra_chunks),
         "--seed", str(args.seed), "--kill-at", str(args.kill_at),
         "--ckpt-every", str(args.ckpt_every),
         "--ckpt-dir", args.ckpt_dir, "--out", args.out,
         "--device", args.device],
        env={**os.environ,
             "PYTHONPATH": os.pathsep.join(
                 [p for p in (os.environ.get("PYTHONPATH"),) if p]
                 + [os.path.join(os.path.dirname(__file__), "..", "src")])})
    if proc.returncode not in (-signal.SIGKILL, 128 + signal.SIGKILL):
        raise SystemExit(f"child should have died by SIGKILL, got "
                         f"{proc.returncode}")
    print(f"child killed -9 at chunk {args.kill_at} "
          f"(rc={proc.returncode})")

    eng = build_engine(args.tenants, args.total_docs, args.k,
                       events_path=os.path.join(args.out, "events.jsonl"),
                       device=dev)
    ck = FleetCheckpointer(args.ckpt_dir, every=args.ckpt_every)
    gen = ck.restore(eng)
    cursor = eng.chunks_ingested
    if cursor > args.kill_at:
        raise SystemExit("checkpoint is ahead of the kill")
    print(f"restored generation {gen} at chunk {cursor}; "
          f"replaying {args.chunks - cursor} chunks")
    eng.attach_checkpointer(ck)
    for i in range(cursor, args.chunks):
        eng.ingest_dense(make_chunk(eng, i, args.seed))
    rec_digest = digest(eng)
    print(f"recovered:  {args.chunks} chunks, digest {rec_digest[:16]}…")
    if rec_digest != ref_digest:
        raise SystemExit(f"recovery is NOT bitwise: {ref_digest} != "
                         f"{rec_digest}")
    print("phase 1 OK: crash/restore/resume is bitwise invisible")

    # ---- phase 2: tier outage under load -------------------------------
    tier = 1  # DRAM
    mid = args.chunks + args.extra_chunks // 2
    occupied = int(eng.meter.occupancy[:, tier].sum())
    with TierOutage(eng, tier=tier, burn_grace=8, hysteresis=2) as out:
        print(f"tier {tier} outage: {out.summary['rows_evacuated']} "
              f"tenants evacuated ({occupied} resident docs), "
              f"bill {out.summary['bill']:.3e}, "
              f"{len(out.summary['infeasible_rows'])} infeasible")
        for i in range(args.chunks, mid):
            eng.ingest_dense(make_chunk(eng, i, args.seed))
        if int(eng.meter.occupancy[:, tier].sum()) != 0:
            raise SystemExit("failed tier still holds documents")
    for i in range(mid, args.chunks + args.extra_chunks):
        eng.ingest_dense(make_chunk(eng, i, args.seed))
    mon = eng._cost_monitor
    evac = np.zeros(eng.m, bool)
    evac[out.summary["rows"]] = True
    if mon.burn_alerted[evac].any():
        raise SystemExit("budget-burn alert false-fired on the evacuation "
                         "bill")
    print(f"phase 2 OK: tier {tier} evacuated, served through the "
          f"outage, recovered after hysteresis")

    eng.finalize()
    rows = evaluate.regret_table(eng)
    print(evaluate.format_regret_table(rows))
    eng._obs.write(args.out)
    res = eng.obs_snapshot()["resilience"]
    print(f"resilience: {res['tier_outages']} outage(s), checkpoint "
          f"generation {res['checkpoint']['generation']}, artifacts in "
          f"{args.out}/ + {args.ckpt_dir}/")
    print("CHAOS-OK")
    return SimpleNamespace(ref=ref, ref_digest=ref_digest,
                           rec_digest=rec_digest, child_rc=proc.returncode,
                           cursor=cursor, resilience=res)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
