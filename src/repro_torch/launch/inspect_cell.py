"""Hillclimb profiler: trace one dry-run cell and print its totals and
the top byte and FLOP contributors — the port's counterpart of the
reference's ``launch.inspect_cell``, which recompiles the cell and walks
its HLO. Here the rows are ``op_count.OpCount``'s: each (operation,
operand shapes) with its count, FLOPs and bytes over the whole step.

With ``--device cuda`` it also runs the cell's per-chip slice on the
card (``card_slice``): the same step, whole model, at the cell's dtypes,
on 1/``n_chips`` of the global batch × sequence tokens, and prints the
step's milliseconds, the top kernels by device time (torch.profiler) and
the counted FLOPs and bytes of the card step beside the dry run's. It
needs a CUDA card and fails without one; it never runs on the CPU.

Usage: python -m repro_torch.launch.inspect_cell --arch llama3.2-1b \
    --shape train_4k [--mesh single] [--top 25] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_count import OpCount
from repro_torch.models import lm
from repro_torch.runtime import steps


def top_contributors(oc: OpCount, top: int = 25):
    print(f"{'bytes':>12s} {'flops':>12s} {'count':>7s}  operation")
    for name, shapes, count, flops, nbytes in oc.top("bytes", top):
        print(f"{nbytes:12.3e} {flops:12.3e} {count:7d}  {name} {shapes}")
    print("\ntop flops:")
    for name, shapes, count, flops, nbytes in oc.top("flops", 10):
        if flops > 0:
            print(f"{nbytes:12.3e} {flops:12.3e} {count:7d}  {name} {shapes}")


def slice_shape(shape, n_chips: int):
    """The per-chip slice of a cell: 1/``n_chips`` of its global batch ×
    sequence tokens as (batch, seq) — the batch split first, then the
    sequence (so where the batch is smaller than the chips, as in
    prefill_32k, the slice's attention covers a shorter context than the
    cell's); a decode step keeps its cache depth, one sequence at least —
    and the factor from the slice's tokens to the cell's."""
    b = max(shape.global_batch // n_chips, 1)
    if shape.kind == "decode":
        return dataclasses.replace(shape, global_batch=b), \
            shape.global_batch / b
    tokens = shape.global_batch * shape.seq_len // n_chips
    if tokens % b:
        raise ValueError(f"{shape.name}'s {tokens} tokens a chip do not "
                         f"split into a batch of {b}")
    sl = dataclasses.replace(shape, global_batch=b, seq_len=tokens // b)
    return sl, shape.global_batch * shape.seq_len / tokens


def _card_inputs(cfg, shape, seed, device):
    """Seeded random weights (and AdamW state) and inputs of a slice:
    (step, state, fresh), where ``step(state, cache)`` runs one step and
    ``fresh()`` makes the cache a serving step takes (None in training),
    so that a caller builds it outside the step it times."""
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    tensor = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    batch = {k: tensor(rng.integers(0, cfg.vocab_size, v.shape,
                                    dtype=np.int32))
             if v.dtype == torch.int32 else
             tensor(rng.standard_normal(v.shape, dtype=np.float32))
             for k, v in specs.batch_specs(cfg, shape).items()}
    if shape.kind == "train":
        batch["example_ids"] = torch.arange(b, dtype=torch.int32,
                                            device=device)
        state = steps.init_train_state(cfg, seed, device=device)
        return (lambda st, _: steps.train_step(st, batch, cfg)), state, \
            (lambda: None)
    params = lm.init_params(cfg, seed, device=device)
    # a fresh cache a step, as deep as the dry run's
    fresh = lambda: lm.init_cache(  # noqa: E731
        cfg, b, _kv_len(cfg, shape), device,
        enc_len=s if cfg.is_encoder_decoder else 0)
    if shape.kind == "prefill":
        return (lambda _, cache: steps.prefill_step(params, batch, cache,
                                                    cfg)), None, fresh
    tok = batch["tokens"][:, 0]
    return (lambda _, cache: steps.decode_step(params, tok, cache, cfg)), \
        None, fresh


def _kv_len(cfg, shape) -> int:
    if cfg.is_encoder_decoder:
        return specs.cache_len(cfg, cfg.decoder_len + 1)
    return specs.cache_len(cfg, shape.seq_len)


def card_slice(arch: str, shape_name: str, mesh_kind: str = "single", *,
               warm: int = 2, timed: int = 5, top: int = 5, seed: int = 0):
    """Run the cell's per-chip slice on the card: ``warm`` steps, then
    ``timed`` steps each timed with CUDA events, one profiled step (the
    top kernels by device time) and one counted step (``OpCount``). A
    serving step's fresh cache is made before its events, its profile
    and its count, which cover the step alone. The peak memory counts a
    timed step's cache. Raises ``RuntimeError`` without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; none is "
                           "available (the slice never runs on the CPU)")
    shape = configs.get_shape(shape_name)
    cfg = dryrun.cell_config(arch, shape, mesh_kind)
    n_chips = make_production_mesh(multi_pod=(mesh_kind == "multi")).size
    sl, scale = slice_shape(shape, n_chips)
    dev = torch.device("cuda")
    step, state, fresh = _card_inputs(cfg, sl, seed, dev)

    def run(st, cache):
        out = step(st, cache)
        return out[0] if sl.kind == "train" else st

    for _ in range(warm):
        state = run(state, fresh())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(timed):
        cache = fresh()  # outside the events' window
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state = run(state, cache)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
        del cache
    peak = torch.cuda.max_memory_allocated()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = fresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = run(state, cache)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    cache = fresh()
    with OpCount() as oc:
        state = run(state, cache)
        torch.cuda.synchronize()
    del cache
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "slice": (sl.global_batch, sl.seq_len), "scale": scale,
            "n_chips": n_chips, "ms": ms, "median_ms": statistics.median(ms),
            "peak_bytes": peak, "count": oc.summary(), "op_count": oc,
            "top_kernels": [(e.key, e.self_device_time_total / 1e3, e.count)
                            for e in kernels[:top]]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("inspect_cell --device cuda: no CUDA card is "
                         "available; the slice never runs on the CPU")
    rec = dryrun.run_cell(args.arch, args.shape, args.mesh, verbose=False)
    if rec["status"] != "ok":
        raise SystemExit(f"{args.arch} × {args.shape}: {rec}")
    shape = configs.get_shape(args.shape)
    cfg = dryrun.cell_config(args.arch, shape, args.mesh)
    oc, _, seconds = dryrun.trace(cfg.replace(seq_parallel=False), shape)
    roof = rec["roofline"]
    print(f"traced in {seconds:.1f}s; totals:", oc.summary())
    print("per chip:", {k: roof[k] for k in (
        "flops_per_chip", "hbm_bytes_per_chip",
        "collective_link_bytes_per_chip", "bottleneck")})
    print("collectives:", roof["detail"]["collective_bytes_by_kind"],
          roof["detail"]["collective_counts"])
    top_contributors(oc, args.top)
    if args.device != "cuda":
        return
    res = card_slice(args.arch, args.shape, args.mesh)
    b, s = res["slice"]
    c = res["count"]
    print(f"\ncard slice {b} x {s} (1/{res['scale']:g} of the cell's "
          f"tokens) on {torch.cuda.get_device_name(0)}: median "
          f"{res['median_ms']:.3f} ms a step over {len(res['ms'])}; peak "
          f"{res['peak_bytes'] / 2**30:.3f} GiB; counted flops "
          f"{c['flops']:.4e} (x {res['scale']:g} = "
          f"{c['flops'] * res['scale']:.4e}, dry run "
          f"{roof['detail']['global_flops']:.4e}), bytes {c['bytes']:.4e}; "
          f"roofline per chip t_compute {roof['t_compute_s'] * 1e3:.3f} ms, "
          f"t_memory {roof['t_memory_s'] * 1e3:.3f} ms")
    for name, dev_ms, calls in res["top_kernels"]:
        print(f"{dev_ms:10.3f} ms {calls:6d}  {name[:100]}")


if __name__ == "__main__":
    main()
