"""The port's dry run (``repro_torch.launch``: ``dryrun``, ``op_count``,
``roofline``, ``specs``, ``inspect_cell``) against the reference's
``repro.launch``.

* Every (arch × shape) cell's setup: ``supports_shape``'s status and
  reason, ``param_count``, ``active_param_count`` and ``model_flops``
  equal to the reference's.
* ``op_count`` against hand counts, and the attention counted by its
  visible pairs (causal, windowed, MLA's head dims), forward and
  backward, as the kernel computes them.
* Reduced llama3.2-1b's train, prefill and decode cells against the
  reference's ``build_cell``, compiled in a subprocess with 8 forced
  host devices on a (2, 4) mesh of Auto axes (``launch/mesh.py``'s
  ``jax.make_mesh`` gives Explicit axes under jax 0.9, on which every
  ``with_sharding_constraint`` fails) and on a (1, 1) mesh:
  - per-chip argument bytes equal to ``argument_size_in_bytes``, but for
    prefill, where jit drops the cache's unused position argument (4
    bytes; ``keep_unused=False``);
  - per-chip output bytes equal to ``output_size_in_bytes`` less XLA's
    tuple index table (8 bytes an output) and, in training, less the
    ``score_ema`` that passes through aliased to its donated argument;
  - per-chip FLOPs at most the reference's (replicated work only adds);
  - on (1, 1), the port's plain-attention route's global FLOPs equal
    ``hlo_parse``'s exactly, and the kernel route's fall short by the
    attention products of the masked pairs alone, which the kernel does
    not compute (measured: 0.9285 of the reference's in training,
    0.9108 in prefill, 1.0 in decode).
* One full-size cell traced on ``meta`` in under 20 s, the CLI's records,
  and ``inspect_cell --device cuda`` failing without a card.
"""
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs.base import supports_shape as r_supports
from repro.launch import hlo_analysis as r_hlo
from repro.models import param_count as r_param_count
from repro_torch import configs as t_configs
from repro_torch.configs.base import supports_shape as t_supports
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import dryrun, inspect_cell
from repro_torch.launch import roofline as t_roof
from repro_torch.launch.op_count import OpCount
from repro_torch.models import attention as t_attention
from repro_torch.models import lm as t_lm
from repro_torch.parallel import sharding as t_shd
from repro_torch.parallel.ctx import LogicalMesh

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without its XLA_FLAGS (it sets
    512 host devices at import, for whatever initializes jax next)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as r_dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return r_dryrun


@pytest.mark.parametrize("shape_name", list(r_configs.SHAPES))
@pytest.mark.parametrize("arch", list(r_configs.list_archs()))
def test_cell_setup_matches_reference(arch, shape_name):
    r_dryrun = _reference_dryrun()
    rshape = r_configs.get_shape(shape_name)
    shape = t_configs.get_shape(shape_name)
    cfg = dryrun.cell_config(arch, shape, "single")
    rcfg = r_configs.get_config(arch).with_dtypes(
        "bfloat16", "bfloat16").replace(remat=True,
                                        seq_parallel=cfg.seq_parallel)
    assert t_supports(cfg, shape) == r_supports(rcfg, rshape)
    n = t_lm.param_count(cfg)
    assert n == r_param_count(rcfg)
    active = dryrun.active_param_count(cfg)
    assert active == r_dryrun.active_param_count(rcfg)
    assert t_roof.model_flops(cfg, shape, active) == \
        r_hlo.model_flops(rcfg, rshape, active)
    assert dryrun.microbatches(cfg) == (8 if n > 5e10 else 1)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_op_count_against_hand_counts(device):
    a = torch.ones(8, 16, device=device)
    b = torch.ones(16, 32, device=device)
    c = torch.ones(32, 4, device=device)
    with OpCount() as oc:
        y = (a @ b) @ c
    # 2·M·N·K each; reads of both operands plus the output's write
    assert oc.flops == 2 * 8 * 32 * 16 + 2 * 8 * 4 * 32
    assert oc.bytes == 4 * (8 * 16 + 16 * 32 + 8 * 32) + \
        4 * (8 * 32 + 32 * 4 + 8 * 4)
    # the (8, 32) intermediate is live when the (8, 4) result is made
    assert oc.peak_bytes == 4 * (8 * 32 + 8 * 4)
    assert oc.summary()["operations"] == 2
    assert y.shape == (8, 4)
    with OpCount() as oc2:
        z = torch.nn.functional.linear(a, b.T, torch.zeros(32, device=device))
        z.view(-1)  # a view moves no bytes
    assert oc2.flops == 2 * 8 * 32 * 16
    assert sum(r[2] for k, r in oc2.rows.items() if k[0] == "view") == 0


def test_memoized_microbatches_count_as_run():
    cfg = t_configs.get_config("llama3.2-1b", reduced=True).replace(
        remat=True)
    shape = t_configs.ShapeConfig("t", seq_len=16, global_batch=4,
                                  kind="train")
    from repro_torch.launch import specs
    from repro_torch.runtime import steps
    got = []
    for memo in (False, True):
        state, batch = specs.train_state_spec(cfg), \
            specs.batch_specs(cfg, shape)
        orig = steps.loss_and_grads
        with OpCount() as oc:
            if memo:
                steps.loss_and_grads = oc.memoize(orig)
            try:
                steps.train_step(state, batch, cfg, microbatches=4)
            finally:
                steps.loss_and_grads = orig
        got.append((oc.summary(), oc.rows))
    assert got[0] == got[1]


ATTN_CASES = {  # (b, sq, skv, h, kvh, hd, hd_v, causal, window)
    "causal": (2, 40, 40, 4, 2, 16, 16, True, 0),
    "windowed": (1, 70, 70, 6, 3, 32, 32, True, 8),
    "cross": (2, 24, 50, 4, 4, 16, 16, False, 0),
    "mla": (1, 33, 33, 4, 4, 24, 16, True, 0),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_counted_by_visible_pairs(case):
    b, sq, skv, h, kvh, hd, hd_v, causal, window = ATTN_CASES[case]
    q = torch.empty(b, sq, h, hd, device="meta", requires_grad=True)
    k = torch.empty(b, skv, kvh, hd, device="meta", requires_grad=True)
    v = torch.empty(b, skv, kvh, hd_v, device="meta", requires_grad=True)
    pairs = int(flash_ops._visible(sq, skv, causal, window, "cpu").sum())
    assert flash_ops.visible_pairs(sq, skv, causal, window) == pairs
    qp = torch.arange(sq, device="meta")[None]
    kp = torch.arange(skv, device="meta")[None]
    with OpCount() as oc:
        out = t_attention.attend(q, k, v, qp, kp, causal=causal,
                                 window=window, flash=True,
                                 cross=not causal)
        fwd = oc.flops
        out.backward(torch.empty_like(out))
    assert out.shape == (b, sq, h, hd_v)
    assert fwd == 2 * (hd + hd_v) * b * h * pairs
    assert oc.flops - fwd == 2 * (3 * hd + 2 * hd_v) * b * h * pairs
    names = {k[0] for k in oc.rows}
    assert {"flash_attention", "flash_attention_bwd"} <= names
    assert not names & {"mm", "bmm"}  # no S × S product ran
    assert not flash_ops.observers


@pytest.mark.parametrize("causal", [True, False])
def test_visible_pairs_closed_form_counts_the_masks(causal):
    # rows with no key (Sq > Skv), ragged Sq < Skv and windows wider and
    # narrower than the keys, against the mask that the plain route builds
    for sq, skv, window in itertools.product((1, 7, 40, 64, 100),
                                             (1, 24, 33, 100),
                                             (0, 1, 7, 33, 1000)):
        want = int(flash_ops._visible(sq, skv, causal, window, "cpu").sum())
        assert flash_ops.visible_pairs(sq, skv, causal, window) == want


REFERENCE_CELLS = r'''
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()  # 8 host devices, before repro.launch.dryrun sets 512
import numpy as np
from jax.sharding import AxisType, Mesh
from repro import configs
from repro.launch import dryrun, hlo_parse
from repro.parallel import ctx as pctx
out = {}
cfg = configs.get_config("llama3.2-1b", reduced=True).with_dtypes(
    "bfloat16", "bfloat16").replace(remat=True)
for dims in ((2, 4), (1, 1)):
    devs = np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims)
    mesh = Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for kind in ("train", "prefill", "decode"):
        shape = configs.ShapeConfig(kind, seq_len=64, global_batch=8,
                                    kind=kind)
        with pctx.use_mesh(mesh), mesh:
            fn, args, in_sh, out_sh = dryrun.build_cell(cfg, shape, mesh)
            compiled = jax.jit(
                fn, in_shardings=in_sh, out_shardings=out_sh,
                donate_argnums=(0,) if shape.is_train else ()
            ).lower(*args).compile()
        mem = compiled.memory_analysis()
        cost = hlo_parse.analyze(compiled.as_text(), int(mesh.devices.size))
        out[f"{kind}:{dims[0]}x{dims[1]}"] = {
            "argument_bytes": int(mem.argument_size_in_bytes),
            "output_bytes": int(mem.output_size_in_bytes),
            "flops": cost.flops}
print(json.dumps(out))
'''


def _stacked_leaves(tree) -> int:
    """Leaves of a port tree as the reference stacks it: a group's
    layers (a list of lists) count once."""
    if isinstance(tree, dict):
        return sum(map(_stacked_leaves, tree.values()))
    if isinstance(tree, (list, tuple)):
        if tree and all(isinstance(g, list) for g in tree):
            return sum(_stacked_leaves(g[0]) for g in tree)
        return sum(map(_stacked_leaves, tree))
    return 1


def test_reduced_cells_against_the_reference_dry_run():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REFERENCE_CELLS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = t_configs.get_config("llama3.2-1b", reduced=True).with_dtypes(
        "bfloat16", "bfloat16").replace(remat=True)
    for kind in ("train", "prefill", "decode"):
        shape = t_configs.ShapeConfig(kind, seq_len=64, global_batch=8,
                                      kind=kind)
        oc, out, _ = dryrun.trace(cfg, shape)
        plain = flash_ops.flash_attention
        flash_ops.flash_attention = flash_ops.reference
        try:
            oc_plain, _, _ = dryrun.trace(cfg, shape)
        finally:
            flash_ops.flash_attention = plain
        for dims in ((2, 4), (1, 1)):
            r = ref[f"{kind}:{dims[0]}x{dims[1]}"]
            mesh = LogicalMesh(dims, ("data", "model"))
            _, args, in_sp, out_sp = dryrun.build_cell(cfg, shape, mesh)
            unused_pos = 4 if kind == "prefill" else 0
            assert t_shd.local_bytes(mesh, args, in_sp) == \
                r["argument_bytes"] + unused_pos, (kind, dims)
            # XLA's output counts 8 bytes a tuple element beside the
            # data; a training step's score_ema (score_mode "nll") passes
            # through, aliased to its donated argument
            got_out = t_shd.local_bytes(mesh, out, out_sp)
            assert r["output_bytes"] == got_out + 8 * _stacked_leaves(out) \
                - (4 if kind == "train" else 0), (kind, dims)
            assert oc.flops / mesh.size <= r["flops"], (kind, dims)
        r1 = ref[f"{kind}:1x1"]
        assert oc_plain.flops == r1["flops"], kind
        # the kernel computes the visible pairs alone: the plain route's
        # surplus is the masked pairs' products
        b, s, h, hd = 8, 64, cfg.n_heads, cfg.head_dim
        masked = b * h * (s * s - flash_ops.visible_pairs(s, s, True, 0))
        layers = cfg.n_layers
        if kind == "train":  # forward, rematerialised forward, backward
            surplus = layers * (2 * 2 * 2 * hd * masked
                                + 2 * 4 * hd * b * h * s * s
                                - 2 * 5 * hd * b * h *
                                flash_ops.visible_pairs(s, s, True, 0))
        elif kind == "prefill":
            surplus = layers * 2 * 2 * hd * masked
        else:
            surplus = 0  # decode attends on the plain route
        assert oc_plain.flops - oc.flops == surplus, kind


def test_full_size_cell_traces_on_meta_in_under_20s():
    dryrun._trace.cache_clear()
    t0 = time.perf_counter()
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", "single",
                          verbose=False)
    took = time.perf_counter() - t0
    assert rec["status"] == "ok" and took < 20.0, (rec["status"], took)
    assert rec["n_chips"] == 256 and rec["n_params"] == 1_235_814_400
    roof = rec["roofline"]
    assert roof["flops_per_chip"] * 256 == roof["detail"]["global_flops"]
    # the forward, backward and recomputed forward of 6·N·D and the
    # attention: the step's FLOPs sit above the model FLOPs
    assert 0.5 < rec["useful_flops_ratio"] < 1.0
    assert rec["memory"]["argument_bytes"] > 0
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
        roof["detail"]["collective_bytes_by_kind"])


def test_collective_rule_on_small_meshes():
    cfg = t_configs.get_config("llama3.2-1b", reduced=True).with_dtypes(
        "bfloat16", "bfloat16")
    params = t_lm.abstract_params(cfg)
    for kind in ("train", "decode"):
        shape = t_configs.ShapeConfig(kind, seq_len=64, global_batch=8,
                                      kind=kind)
        one = LogicalMesh((1, 1), ("data", "model"))
        assert t_roof.collectives(cfg, shape, one, params,
                                  t_shd.param_specs(one, params))[2] == 0
        mesh = LogicalMesh((2, 4), ("data", "model"))
        by_kind, counts, link = t_roof.collectives(
            cfg, shape, mesh, params, t_shd.param_specs(mesh, params,
                                                        fsdp=kind == "train"))
        # TP all-reduces after wo and w_down: 2 layers × 2, × 3 passes
        # in training; 8·64/2 tokens a data shard × d_model × 2 bytes
        per = 8 * 64 // 2 * cfg.d_model * 2 if kind == "train" else \
            8 // 2 * cfg.d_model * 2
        passes = 3 if kind == "train" else 1
        assert counts["all-reduce"] == 4 * passes
        assert by_kind["all-reduce"] == 4 * passes * per
        assert ("all-gather" in by_kind) == (kind == "train")
    pod = LogicalMesh((2, 2, 2), ("pod", "data", "model"))
    by_kind, _, _ = t_roof.collectives(
        cfg, t_configs.ShapeConfig("t", 64, 8, "train"), pod, params,
        t_shd.param_specs(pod, params))
    assert by_kind["all-reduce"] > 0 and by_kind["reduce-scatter"] > 0


def test_cli_writes_a_record_per_cell(tmp_path):
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                     "--mesh", "both", "--out", str(tmp_path)])
    assert exit_.value.code == 0
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"whisper-base__long_500k__{mesh}.json")
                         .read_text())
        assert rec["status"] == "skipped"
        assert rec["reason"] == r_supports(
            r_configs.get_config("whisper-base"),
            r_configs.get_shape("long_500k"))[1]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "whisper-base__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert set(rec) == {"arch", "shape", "mesh", "status", "n_chips",
                        "n_params", "trace_s", "memory", "operations",
                        "roofline", "model_flops", "useful_flops_ratio"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert set(rec["roofline"]) == set(r_hlo.Roofline(
        1, 1, 1, 1).as_dict())


def test_inspect_cell_on_the_card_fails_without_one(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        inspect_cell.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                           "--device", "cuda"])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        inspect_cell.card_slice("llama3.2-1b", "train_4k")
    assert capsys.readouterr().out == ""  # nothing ran before the refusal


def test_inspect_cell_prints_the_top_contributors(capsys):
    inspect_cell.main(["--arch", "whisper-base", "--shape", "decode_32k",
                       "--top", "5"])
    out = capsys.readouterr().out
    assert "totals:" in out and "top flops:" in out and " mm " in out


def test_slice_shape_is_a_chip_of_the_cell():
    sl, scale = inspect_cell.slice_shape(t_configs.get_shape("train_4k"), 256)
    assert (sl.global_batch, sl.seq_len, scale) == (1, 4096, 256)
    sl, scale = inspect_cell.slice_shape(t_configs.get_shape("prefill_32k"),
                                         256)
    assert (sl.global_batch, sl.seq_len, scale) == (1, 4096, 256)
    sl, scale = inspect_cell.slice_shape(t_configs.get_shape("decode_32k"),
                                         512)
    assert (sl.global_batch, sl.seq_len, scale) == (1, 32768, 128)
    assert np.isclose(scale, 128)
