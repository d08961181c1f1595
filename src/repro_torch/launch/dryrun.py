"""Dry run: trace every (arch × input-shape × mesh) cell's step on the
``meta`` device with abstract params, optimizer state, batch and caches,
and record per-chip memory, operation counts and collective traffic for
the roofline — the port's counterpart of the reference's
``launch.dryrun``.

The reference lowers and compiles each cell for 512 placeholder TPU
devices with explicit shardings and reads ``memory_analysis()``,
``cost_analysis()`` and the collectives of the partitioned HLO. The port
has no compiler and no partitioner: it runs the cell's step
(``runtime.steps.train_step`` with the reference's microbatches,
``prefill_step`` or ``decode_step``) once on ``meta`` under
``op_count.OpCount``, prices it per chip at even partition
(``roofline``), and takes the per-chip argument and output bytes from
the rule table (``parallel.sharding.local_bytes``). ``trace_s`` stands
for ``lower_s`` and ``compile_s``; ``temp_bytes`` is the trace's peak
live bytes over the chips; there is no generated code, so no
``generated_code_bytes``. A cell whose step cannot be traced records
``"status": "error"`` with its traceback, as the reference's loop does;
it is never dropped.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

from repro_torch import configs
from repro_torch.configs.base import supports_shape
from repro_torch.core.topk import ReservoirState
from repro_torch.launch import roofline as roof_mod
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_count import OpCount
from repro_torch.models import lm
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import steps

_SMALL = ("loss", "aux_loss", "grad_norm", "reservoir_writes")


def train_state_specs(mesh, state: steps.TrainState) -> steps.TrainState:
    return steps.TrainState(params=shd.param_specs(mesh, state.params),
                            opt=shd.opt_specs(mesh, state.opt), step=(),
                            reservoir=ReservoirState((), (), ()),
                            score_ema=())


def microbatches(cfg) -> int:
    """Big models microbatch so the remat-saved stack fits (the
    reference's rule)."""
    return 8 if lm.param_count(cfg) > 5e10 else 1


def build_cell(cfg, shape, mesh):
    """Returns (fn, example_args, in_specs, out_specs)."""
    logits_spec = pctx.spec(mesh, (pctx.BATCH, pctx.MODEL),
                            (shape.global_batch, cfg.vocab_size))
    if shape.kind == "train":
        state = specs.train_state_spec(cfg)
        batch = specs.batch_specs(cfg, shape)
        st_sp = train_state_specs(mesh, state)
        micro = microbatches(cfg)

        def fn(state, batch):
            new_state, metrics = steps.train_step(state, batch, cfg,
                                                  microbatches=micro)
            return new_state, {k: metrics[k] for k in _SMALL}

        return (fn, (state, batch), (st_sp, shd.batch_specs(mesh, batch)),
                (st_sp, {k: () for k in _SMALL}))

    params = lm.abstract_params(cfg)
    if shape.kind == "prefill":
        batch = specs.batch_specs(cfg, shape)
        cache = specs.cache_spec(cfg, shape)
        c_sp = shd.cache_specs(mesh, cache)

        def fn(params, batch, cache):
            return steps.prefill_step(params, batch, cache, cfg)

        return (fn, (params, batch, cache),
                (shd.param_specs(mesh, params),
                 shd.batch_specs(mesh, batch), c_sp), (logits_spec, c_sp))

    # decode — weights TP/EP-only (no FSDP) when they fit one model-axis
    # shard (≲20B params): a per-token weight all-gather has nothing to
    # amortize it. Bigger models keep FSDP.
    p_sp = shd.param_specs(mesh, params,
                           fsdp=lm.param_count(cfg) >= 2e10)
    tok, cache = specs.decode_inputs(cfg, shape)
    c_sp = shd.cache_specs(mesh, cache)
    t_sp = pctx.spec(mesh, (pctx.BATCH,), tok.shape)

    def fn(params, token, cache):
        return steps.decode_step(params, token, cache, cfg)

    return fn, (params, tok, cache), (p_sp, t_sp, c_sp), (logits_spec, c_sp)


def trace(cfg, shape):
    """(``OpCount``, outputs, seconds) of the cell's step run once on
    ``meta``. Every microbatch of a training step runs the same
    operations on the same shapes, so ``steps.loss_and_grads`` runs
    memoized (``OpCount.memoize``): the counts are those of running each
    microbatch."""
    fn, args, _, _ = build_cell(cfg, shape, make_production_mesh())
    t0 = time.perf_counter()
    orig = steps.loss_and_grads
    with OpCount() as oc:
        steps.loss_and_grads = oc.memoize(orig)
        try:
            out = fn(*args)
        finally:
            steps.loss_and_grads = orig
    return oc, out, time.perf_counter() - t0


@functools.lru_cache(maxsize=2)
def _trace(cfg, shape):
    """``trace``'s count summary, outputs and seconds. The step does not
    depend on the mesh, so a cell traced for one mesh serves the other
    (``cfg.seq_parallel``, a layout flag for the reference's
    partitioner, is not read by the port's models)."""
    oc, out, seconds = trace(cfg, shape)
    return oc.summary(), out, seconds


def cell_config(arch: str, shape, mesh_kind: str):
    """The reference's cell setup: bfloat16 params and activations,
    ``remat``, and sequence parallelism for train and prefill (on the
    multi-pod mesh for dense and SSM archs only)."""
    cfg = configs.get_config(arch).with_dtypes("bfloat16", "bfloat16")
    use_sp = shape.kind in ("train", "prefill") and \
        (cfg.n_experts == 0 or mesh_kind == "single")
    return cfg.replace(remat=True, seq_parallel=use_sp)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True) -> dict:
    shape = configs.get_shape(shape_name)
    cfg = cell_config(arch, shape, mesh_kind)
    ok, why = supports_shape(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size
    _, args, in_sp, out_sp = build_cell(cfg, shape, mesh)
    count, out, trace_s = _trace(cfg.replace(seq_parallel=False), shape)
    params = args[0].params if shape.is_train else args[0]
    coll = roof_mod.collectives(
        cfg, shape, mesh, params,
        in_sp[0].params if shape.is_train else in_sp[0],
        microbatches(cfg) if shape.is_train else 1)
    roof = roof_mod.roofline(count, n_chips, coll, cfg.activation_dtype)
    n_params = lm.param_count(cfg)
    mf = roof_mod.model_flops(cfg, shape, active_param_count(cfg))
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "n_params": n_params,
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": shd.local_bytes(mesh, args, in_sp),
            "output_bytes": shd.local_bytes(mesh, out, out_sp),
            "temp_bytes": count["peak_live_bytes"] // n_chips,
        },
        "operations": count["operations"],
        "roofline": roof.as_dict(),
        "model_flops": mf,
        "useful_flops_ratio": (mf / n_chips / roof.flops) if roof.flops else None,
    })
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_kind}] traced in "
              f"{trace_s:.1f}s  chips={n_chips}")
        print("  memory:", rec["memory"])
        print("  per-chip: flops={:.3e} bytes={:.3e} link_bytes={:.3e}".format(
            roof.flops, roof.hbm_bytes, roof.collective_link_bytes))
        print("  roofline: t_comp={:.2e}s t_mem={:.2e}s t_coll={:.2e}s -> {}".format(
            roof.t_compute, roof.t_memory, roof.t_collective, roof.bottleneck))
    return rec


def active_param_count(cfg) -> int:
    """Active params per token (MoE counts shared + top-k routed only)."""
    total = lm.param_count(cfg)
    if cfg.n_experts == 0:
        return total
    # subtract inactive expert weights
    glu = 3  # w_up, w_gate, w_down
    per_expert = glu * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = sum(s.count for s in cfg.layers if s.ffn == "moe")
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k_experts) * per_expert
    return total - inactive


def cells(mesh_kind: str, only_arch=None, only_shape=None):
    for arch in configs.list_archs():
        if only_arch and arch != only_arch:
            continue
        for shape_name in configs.SHAPES:
            if only_shape and shape_name != only_shape:
                continue
            yield arch, shape_name, mesh_kind


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_fail = 0
    # by arch and shape, both meshes together: one trace serves both
    for arch, shape_name, _ in cells(args.mesh, args.arch, args.shape):
        if not args.all and (args.arch is None or args.shape is None):
            continue
        for mesh_kind in mesh_kinds:
            path = os.path.join(
                args.out, f"{arch}__{shape_name}__{mesh_kind}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            try:
                rec = run_cell(arch, shape_name, mesh_kind)
            except Exception as e:  # record and continue
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
                n_fail += 1
                print(f"[{arch} × {shape_name} × {mesh_kind}] FAILED: {e!r}")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"dry-run done; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
