"""The port's training path against the reference's on the CPU: AdamW and
its schedules, the synthetic data and the elastic loader, the plain
versions of the flash_attention backward, ``lm_loss`` and its gradients,
``train_step`` in every score mode and with microbatches, and the
training loop and launcher; then the guards (no JAX, entry points need a
card or ``device="cpu"``).

The reference's weights and state are carried across with
``from_reference_params`` / ``from_reference_train_state`` and the
batches come from the same seeds. Tolerances, each with its reason:

* AdamW: parameters and moments within rtol 1e-6 of the reference's on
  the same numpy params and grads (float32 elementwise operations in the
  reference's order; only pow and the clip's sum of squares may round
  differently).
* data: bit-equal (the same NumPy code).
* backward plain versions: each gradient within 1e-5 of its largest
  magnitude (float32 sums in another order, Delta taken as rowsum(dO∘O)
  where autograd takes rowsum(P∘dP)).
* ``lm_loss``: loss and per-example NLL within rtol 1e-5, each gradient
  leaf within 1e-5 of its largest magnitude (matrix products and
  reductions summed in another order by another backend).
* ``train_step``: loss, NLL and grad_norm within rtol 1e-5, score_ema
  within rtol 1e-5, the reservoir's scores within 1e-5 of the batch's
  largest NLL (centred scores are differences of NLLs), first moments
  within 1e-5 of each leaf's largest magnitude; parameters within 1e-5 of each leaf's largest magnitude,
  except where the reference's gradient lies within that tolerance of
  zero: there AdamW's step, lr·m̂/(√v̂ + 1e-8), is not fixed by float32
  gradient arithmetic and may differ by up to 2·lr (the test asserts
  that fewer than 1 element in 1000 of a leaf takes this exception).
  Each step starts from the reference's state carried across, so one
  step's undetermined elements do not feed the next.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs.base import ShapeConfig as RShape
from repro.core import topk as r_topk
from repro.data import pipeline as r_pipe
from repro.data import synthetic as r_syn
from repro.kernels.flash_attention import ref as r_fa
from repro.models import lm as r_lm
from repro.optim import adamw as r_adamw
from repro.optim import schedules as r_sched
from repro.runtime import steps as r_steps
from repro_torch import configs as t_configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import interestingness as t_interest
from repro_torch.core import placement, shp, tiers
from repro_torch.data import pipeline as t_pipe
from repro_torch.data import synthetic as t_syn
from repro_torch.data.curation import TopKCurator
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.models import lm as t_lm
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import schedules as t_sched
from repro_torch.runtime import steps as t_steps
from repro_torch.runtime import train_loop

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
SHAPE = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
R_SHAPE = RShape("t", seq_len=32, global_batch=8, kind="train")


def _cfg():
    return t_configs.get_config(ARCH, reduced=True)


def _r_cfg():
    return r_configs.get_config(ARCH, reduced=True)


def _to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _rel_close(got, want, frac, what):
    """|got − want| <= frac · max|want| elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lim = frac * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= lim, f"{what}: max abs diff {err} > {lim}"


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (4, 3), "blk": [{"x": (5,)}, {"x": (2, 2)}], "e": (7,)}


def _opt_tree(rng, scale):
    """Random float32 arrays in a dict with a nested list of dicts, as the
    port's params are laid out."""
    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return build(OPT_SHAPES)


@pytest.mark.parametrize("grad_clip,grad_scale", [(1.0, 3.0), (1.0, 0.01),
                                                  (0.0, 3.0)])
def test_adamw_matches_reference(grad_clip, grad_scale):
    rng = np.random.default_rng(7)
    params = _opt_tree(rng, 1.0)
    r_params = params
    t_params = t_adamw.tree_map(torch.tensor, params)
    r_state = r_adamw.init(r_params)
    t_state = t_adamw.init(t_params)
    for step in range(3):
        grads = _opt_tree(rng, grad_scale)
        r_params, r_state, r_gn = r_adamw.apply(
            r_params, grads, r_state, lr=1e-2, grad_clip=grad_clip)
        t_params, t_state, t_gn = t_adamw.apply(
            t_params, t_adamw.tree_map(torch.tensor, grads), t_state,
            lr=1e-2, grad_clip=grad_clip)
        np.testing.assert_allclose(float(t_gn), float(r_gn), rtol=1e-6)
        assert int(t_state.step) == int(r_state.step) == step + 1
        for got, want in ((t_params, r_params), (t_state.m, r_state.m),
                          (t_state.v, r_state.v)):
            want = dict(_leaves_with_paths(jax.tree.map(np.asarray, want)))
            for path, a in _leaves_with_paths(got):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), want[path], rtol=1e-6,
                                           atol=1e-9)
    if grad_clip:
        assert float(t_gn) > 0
    else:
        assert float(t_gn) == 0.0


def test_adamw_keeps_inputs_and_moments_in_float32():
    p = {"a": torch.ones(3, dtype=torch.bfloat16)}
    st = t_adamw.init(p)
    assert st.m["a"].dtype == torch.float32 and int(st.step) == 0
    g = {"a": torch.full((3,), 0.5, dtype=torch.bfloat16)}
    p2, st2, _ = t_adamw.apply(p, g, st, lr=0.1)
    assert p2["a"].dtype == torch.bfloat16 and st2.v["a"].dtype == \
        torch.float32
    assert torch.equal(p["a"], torch.ones(3, dtype=torch.bfloat16))
    assert int(st.step) == 0 and int(st2.step) == 1


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)),
    ("cosine", dict(peak_lr=1e-3, warmup_steps=0, total_steps=50,
                    min_ratio=0.0)),
    ("wsd", dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)),
    ("wsd", dict(peak_lr=1e-3, warmup_steps=5, total_steps=40,
                 decay_frac=0.3, min_ratio=0.1))])
def test_schedules_match_reference(name, kw):
    steps = np.arange(0, kw["total_steps"] + 5)
    want = np.asarray(getattr(r_sched, name)(jnp.asarray(steps), **kw))
    got = getattr(t_sched, name)(torch.as_tensor(steps), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    for s in (0, 7, int(kw["total_steps"])):  # a Python int step
        np.testing.assert_allclose(
            float(getattr(t_sched, name)(s, **kw)),
            float(getattr(r_sched, name)(s, **kw)), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# data: synthetic and the elastic loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (1, 3), (5, 11)])
def test_synthetic_bit_equal(seed, step):
    cfg, rcfg = _cfg(), _r_cfg()
    for index in (0, 1, 17, 2 ** 31 - 3):
        np.testing.assert_array_equal(
            t_syn.example_tokens(cfg, 24, seed, step, index),
            r_syn.example_tokens(rcfg, 24, seed, step, index))
    a = t_syn.make_batch(cfg, SHAPE, seed=seed, step=step)
    b = r_syn.make_batch(rcfg, R_SHAPE, seed=seed, step=step)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    c = t_syn.make_batch(cfg, SHAPE, seed=seed, indices=[4, 9], seq_len=12)
    d = r_syn.make_batch(rcfg, R_SHAPE, seed=seed, indices=[4, 9], seq_len=12)
    for k in c:
        np.testing.assert_array_equal(c[k], d[k])


@pytest.mark.parametrize("seed,rank,size", [(0, 0, 1), (1, 1, 2), (2, 3, 4),
                                            (3, 0, 8)])
def test_stream_loader_bit_equal(seed, rank, size):
    t = t_pipe.StreamLoader(_cfg(), SHAPE, seed=seed,
                            shard=t_pipe.ShardInfo(rank, size))
    r = r_pipe.StreamLoader(_r_cfg(), R_SHAPE, seed=seed,
                            shard=r_pipe.ShardInfo(rank, size))
    for step in (0, 2, 9):
        np.testing.assert_array_equal(t.example_ids(step),
                                      r.example_ids(step))
        a, b = t.batch_for_step(step), r.batch_for_step(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        t_pipe.StreamLoader(_cfg(), SHAPE, shard=t_pipe.ShardInfo(0, 3))


def _loader(rank=0, size=1, seed=0):
    return t_pipe.StreamLoader(_cfg(), ShapeConfig("t", seq_len=16,
                                                   global_batch=8,
                                                   kind="train"),
                               seed=seed, shard=t_pipe.ShardInfo(rank, size))


def test_loader_elastic_repartition_and_resume():
    """tests/test_pipeline.py's properties on the port's loader: the union
    of the ranks' batches is the same stream for dp 2 and 4, steps are
    disjoint, a resume mid-stream replays the same batches, the seed
    changes the stream, and iteration follows batch_for_step."""
    def union(size):
        rows = {}
        for r in range(size):
            b = _loader(rank=r, size=size).batch_for_step(5)
            for i, eid in enumerate(b["example_ids"]):
                rows[int(eid)] = b["tokens"][i]
        return rows
    u2, u4 = union(2), union(4)
    assert set(u2) == set(u4)
    for eid in u2:
        np.testing.assert_array_equal(u2[eid], u4[eid])
    assert set(_loader().example_ids(0)).isdisjoint(_loader().example_ids(1))
    full = [_loader().batch_for_step(s)["tokens"] for s in range(4)]
    resumed = [_loader().batch_for_step(s)["tokens"] for s in range(2, 4)]
    np.testing.assert_array_equal(full[2], resumed[0])
    np.testing.assert_array_equal(full[3], resumed[1])
    assert not np.array_equal(_loader(seed=0).batch_for_step(0)["tokens"],
                              _loader(seed=1).batch_for_step(0)["tokens"])
    it = iter(_loader())
    for s in range(2):
        np.testing.assert_array_equal(next(it)["tokens"], full[s])


# ---------------------------------------------------------------------------
# flash_attention's backward: the plain versions
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, KV, hd, causal, window): g = 1 and 4, causal and not,
# windows, Sq < Skv, and Sq > Skv with rows whose keys are all masked;
# then the card's split seams at batch 1: g = 12 over KV 1 and 2, g = 6,
# and a ragged Skv at head dim 128
BWD_CASES = [(2, 16, 16, 4, 4, 16, True, 0), (1, 24, 24, 8, 2, 16, True, 5),
             (1, 10, 6, 4, 1, 16, True, 0), (1, 8, 20, 4, 4, 32, True, 0),
             (1, 12, 12, 4, 1, 16, False, 4), (1, 14, 9, 4, 4, 16, True, 3),
             (2, 9, 9, 4, 1, 32, False, 0),
             (1, 20, 20, 12, 1, 16, True, 0), (1, 18, 18, 24, 2, 32, True, 0),
             (1, 15, 15, 6, 1, 16, True, 6), (1, 10, 37, 12, 1, 128, True, 0)]


def bwd_case(b, sq, skv, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, h, hd), (b, skv, kvh, hd),
                           (b, skv, kvh, hd), (b, sq, h, hd)))


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", BWD_CASES)
def test_reference_backward_matches_autograd_and_jax(b, sq, skv, h, kvh, hd,
                                                     causal, window):
    qn, kn, vn, don = bwd_case(b, sq, skv, h, kvh, hd, sq * 31 + skv)
    kw = dict(causal=causal, window=window)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    out = t_fa.flash_attention(q, k, v, **kw)  # the CPU: the plain version
    out.backward(torch.tensor(don))
    with torch.no_grad():
        lse = t_fa.reference_lse(q, k, v, **kw)
        got = t_fa.reference_backward(q, k, v, out, lse, torch.tensor(don),
                                      **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    g = h // kvh
    r_out, vjp = jax.vjp(
        lambda q_, k_, v_: r_fa.flash_attention(q_, k_, v_, **kw),
        jnp.asarray(qn), jnp.asarray(np.repeat(kn, g, axis=2)),
        jnp.asarray(np.repeat(vn, g, axis=2)))
    r_dq, r_dk, r_dv = (np.asarray(x) for x in vjp(jnp.asarray(don)))
    r_dk = r_dk.reshape(b, skv, kvh, g, hd).sum(3)
    r_dv = r_dv.reshape(b, skv, kvh, g, hd).sum(3)
    _rel_close(out.detach().numpy(), np.asarray(r_out), 1e-5, "out")
    for name, a, auto, want in (("dq", got[0], q.grad, r_dq),
                                ("dk", got[1], k.grad, r_dk),
                                ("dv", got[2], v.grad, r_dv)):
        assert a.shape == auto.shape and a.dtype == torch.float32
        _rel_close(a.numpy(), auto.numpy(), 1e-5, f"{name} vs autograd")
        _rel_close(a.numpy(), want, 1e-5, f"{name} vs jax.vjp")
    if causal and sq > skv:  # rows with no key: no dq, v gets dO / Skv
        assert not got[0][:, :sq - skv].abs().any()


# ---------------------------------------------------------------------------
# lm_loss and train_step against the reference
# ---------------------------------------------------------------------------

def _ref_state(seed=0, reservoir_k=16):
    cfg = _r_cfg()
    st = r_steps.init_train_state(cfg, jax.random.PRNGKey(seed),
                                  reservoir_k=reservoir_k)
    return st, t_steps.from_reference_train_state(
        jax.tree.map(np.asarray, st), _cfg(), device="cpu")


def _port_tree(tree_np):
    return t_lm.from_reference_params(jax.tree.map(np.asarray, tree_np),
                                      _cfg(), device="cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_lm_loss_and_grads_match_reference(use_kernel):
    r_state, t_state = _ref_state(seed=3)
    batch = r_pipe.StreamLoader(_r_cfg(), R_SHAPE, seed=4).batch_for_step(0)
    batch["labels"][0, :5] = -1  # masked labels count nowhere
    (r_loss, r_met), r_grads = jax.value_and_grad(
        lambda p: r_lm.lm_loss(p, _r_cfg(), jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(r_state.params)
    loss, met, grads = t_steps.loss_and_grads(
        t_state.params, _cfg(), _to_torch(batch), use_kernel=use_kernel)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    for key in ("loss", "per_example_nll", "tokens"):
        np.testing.assert_allclose(met[key].numpy(), np.asarray(r_met[key]),
                                   rtol=1e-5)
    assert float(met["aux_loss"]) == 0.0
    want = dict(_leaves_with_paths(_port_tree(r_grads)))
    for path, g in _leaves_with_paths(grads):
        assert g.shape == want[path].shape and bool(g.abs().any()), path
        _rel_close(g.numpy(), want[path].numpy(), 1e-5, str(path))


def _check_params(t_params, r_params, r_m, lr, what):
    """The parameters' tolerance of the module docstring."""
    want = dict(_leaves_with_paths(_port_tree(r_params)))
    grads = dict(_leaves_with_paths(_port_tree(r_m)))
    for path, p in _leaves_with_paths(t_params):
        w, m = want[path].numpy(), grads[path].numpy()
        free = np.abs(m) <= 1e-5 * np.abs(m).max()
        err = np.abs(p.numpy() - w)
        off = err > 1e-5 * np.abs(w).max()
        assert off.mean() < 1e-3, (what, path, off.mean())
        assert free[off].all() and (err[off] <= 2 * lr).all(), \
            (what, path, float(err.max()))


def _check_reservoir_exact(t_res, scores, r_before, ids):
    """The port's reservoir equals the reference's core.topk.update fed
    the port's own scores."""
    want, _ = r_topk.update(r_before, jnp.asarray(scores.numpy()),
                            jnp.asarray(ids))
    np.testing.assert_array_equal(t_res.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(t_res.scores.numpy(),
                                  np.asarray(want.scores))
    assert int(t_res.seen) == int(want.seen)


def _port_scores(nll, mode, ema, step):
    if mode == "nll_centered":
        return nll - torch.mean(nll)
    if mode == "nll_relative":
        return t_interest.ema_relative(nll, ema, step)[0]
    return nll


@pytest.mark.parametrize("mode,micro", [("nll", 1), ("nll_centered", 1),
                                        ("nll_relative", 1), ("nll", 2)])
def test_train_step_matches_reference(mode, micro):
    rcfg, cfg, lr = _r_cfg(), _cfg(), 1e-3
    r_state, t_state = _ref_state(seed=1)
    loader = r_pipe.StreamLoader(rcfg, R_SHAPE, seed=5)
    fn = jax.jit(lambda s, b: r_steps.train_step(
        s, b, rcfg, lr=lr, score_mode=mode, microbatches=micro))
    for step in range(2):
        # each step from the same state: the reference's, carried across
        # (the second from nonzero moments, score_ema and reservoir)
        t_state = t_steps.from_reference_train_state(
            jax.tree.map(np.asarray, r_state), cfg, device="cpu")
        batch = loader.batch_for_step(step)
        r_before, t_before = r_state, t_state
        r_state, r_met = fn(r_state, jax.tree.map(jnp.asarray, batch))
        t_state, t_met = t_steps.train_step(t_state, _to_torch(batch), cfg,
                                            lr=lr, score_mode=mode,
                                            microbatches=micro)
        assert set(t_met) == set(r_met)
        for key in ("loss", "grad_norm", "per_example_nll", "tokens",
                    "reservoir_threshold"):
            np.testing.assert_allclose(t_met[key].numpy(),
                                       np.asarray(r_met[key]), rtol=1e-5,
                                       err_msg=key)
        assert float(t_met["aux_loss"]) == 0.0
        np.testing.assert_allclose(float(t_state.score_ema),
                                   float(r_state.score_ema), rtol=1e-5)
        assert int(t_state.step) == int(r_state.step) == step + 1
        assert int(t_state.opt.step) == int(r_state.opt.step) == step + 1
        want = dict(_leaves_with_paths(_port_tree(r_state.opt.m)))
        for path, a in _leaves_with_paths(t_state.opt.m):
            _rel_close(a.numpy(), want[path].numpy(), 1e-5, f"m {path}")
        _check_params(t_state.params, r_state.params, r_state.opt.m, lr,
                      f"{mode} step {step}")
        # the reservoir: the reference's merge fed the port's own scores
        nll = t_met["per_example_nll"]
        _check_reservoir_exact(
            t_state.reservoir,
            _port_scores(nll, mode, t_before.score_ema, t_before.step),
            r_before.reservoir, batch["example_ids"])
        # end to end, where no two NLLs of the batch lie within 1e-5
        r_nll = np.sort(np.asarray(r_met["per_example_nll"], np.float64))
        assert (np.diff(r_nll) > 1e-5 * np.abs(r_nll[1:])).all()
        np.testing.assert_array_equal(t_state.reservoir.ids.numpy(),
                                      np.asarray(r_state.reservoir.ids))
        np.testing.assert_array_equal(t_met["wrote_mask"].numpy(),
                                      np.asarray(r_met["wrote_mask"]))
        assert int(t_met["reservoir_writes"]) == int(
            r_met["reservoir_writes"])
        np.testing.assert_allclose(t_state.reservoir.scores.numpy(),
                                   np.asarray(r_state.reservoir.scores),
                                   rtol=0, atol=1e-5 * np.abs(r_nll).max())


def test_train_step_without_example_ids_and_bad_arguments():
    cfg = _cfg()
    st = t_steps.init_train_state(cfg, seed=0, reservoir_k=4, device="cpu")
    batch = _to_torch(t_syn.make_batch(cfg, ShapeConfig(
        "t", seq_len=8, global_batch=4, kind="train")))
    st2, met = t_steps.train_step(st, batch, cfg)
    np.testing.assert_array_equal(np.sort(st2.reservoir.ids.numpy()),
                                  [0, 1, 2, 3])  # ids step * B + slot
    st3, _ = t_steps.train_step(st2, batch, cfg)
    assert set(st3.reservoir.ids.tolist()) <= set(range(8))
    with pytest.raises(ValueError, match="score_mode"):
        t_steps.train_step(st, batch, cfg, score_mode="entropy")
    with pytest.raises(ValueError, match="microbatches"):
        t_steps.train_step(st, batch, cfg, microbatches=3)


def test_train_step_score_mode_wiring():
    """tests/test_score_detrending.py's wiring: nll_relative updates the
    EMA in the state, nll leaves it at 0."""
    cfg = _cfg()
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    batch = _to_torch(t_syn.make_batch(cfg, shape))
    batch["example_ids"] = torch.arange(4, dtype=torch.int32)
    st = t_steps.init_train_state(cfg, seed=0, reservoir_k=8, device="cpu")
    st2, _ = t_steps.train_step(st, batch, cfg, score_mode="nll_relative")
    assert float(st2.score_ema) != 0.0
    st3, _ = t_steps.train_step(st, batch, cfg, score_mode="nll")
    assert float(st3.score_ema) == 0.0


def test_abstract_train_state_matches_init():
    cfg = _cfg()
    abstract = t_steps.abstract_train_state(cfg, reservoir_k=16)
    real = t_steps.init_train_state(cfg, seed=0, reservoir_k=16,
                                    device="cpu")
    from repro_torch.checkpoint.manager import tree_flatten
    a_leaves, a_def = tree_flatten(abstract)
    r_leaves, r_def = tree_flatten(real)
    assert a_def == r_def and len(a_leaves) == len(r_leaves)
    for a, r in zip(a_leaves, r_leaves):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (r.shape, r.dtype)
    assert sum(x.numel() for x in t_adamw.tree_leaves(abstract.params)) == \
        t_lm.param_count(cfg) == r_lm.param_count(_r_cfg())


def test_prefill_and_decode_steps_are_the_models():
    cfg = _cfg()
    p = t_lm.init_params(cfg, seed=2, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 6)))
    cache = t_lm.init_cache(cfg, 2, 8, device="cpu")
    logits, cache = t_steps.prefill_step(p, {"tokens": toks}, cache, cfg)
    ref, _ = t_lm.forward(p, cfg, {"tokens": toks})
    torch.testing.assert_close(logits, ref[:, -1], rtol=2e-5, atol=2e-5)
    step_logits, cache = t_steps.decode_step(p, toks[:, 0], cache, cfg)
    assert step_logits.shape == (2, cfg.vocab_size) and cache["pos"] == 7


# ---------------------------------------------------------------------------
# the training loop on the CPU (tests/test_train_loop.py's behaviours)
# ---------------------------------------------------------------------------

def _loop_loader(seed):
    return t_pipe.StreamLoader(_cfg(), SHAPE, seed=seed)


def test_loss_decreases():
    rep = train_loop.run(_cfg(), _loop_loader(0), loop=train_loop.LoopConfig(
        total_steps=30, ckpt_every=1000, lr=3e-3), device="cpu")
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    assert last < first - 0.2, (first, last)
    assert rep.steps_run == 30 and int(rep.final_state.step) == 30


def test_resume_is_deterministic(tmp_path):
    """8 straight steps equal 4 steps, a checkpoint, and 4 resumed steps:
    bit for bit, under torch.use_deterministic_algorithms (the CPU's
    embedding backward accumulates in parallel, in no fixed order, once
    a batch is large enough)."""
    cfg = _cfg()
    loop = train_loop.LoopConfig(total_steps=8, ckpt_every=4, lr=1e-3)
    loader = _loop_loader(1)
    torch.use_deterministic_algorithms(True)
    try:
        rep_a = train_loop.run(cfg, loader, loop=loop,
                               ckpt=CheckpointManager(str(tmp_path / "a")),
                               device="cpu")
        mgr_b = CheckpointManager(str(tmp_path / "b"))
        rep_b1 = train_loop.run(cfg, loader, loop=train_loop.LoopConfig(
            total_steps=4, ckpt_every=4, lr=1e-3), ckpt=mgr_b, device="cpu")
        rep_b2 = train_loop.run(cfg, loader, loop=loop, ckpt=mgr_b,
                                device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    assert rep_b1.steps_run == 4 and rep_b2.resumed_from == 4
    assert rep_b2.steps_run == 4
    assert rep_a.losses[4:] == rep_b2.losses
    a_leaves = t_adamw.tree_leaves(rep_a.final_state.params)
    b_leaves = t_adamw.tree_leaves(rep_b2.final_state.params)
    assert all(torch.equal(x, y) for x, y in zip(a_leaves, b_leaves))
    assert torch.equal(rep_a.final_state.reservoir.ids,
                       rep_b2.final_state.reservoir.ids)


def test_reservoir_in_train_state_tracks_hardest_examples():
    cfg = _cfg()
    loader = _loop_loader(2)
    state = t_steps.init_train_state(cfg, seed=0, reservoir_k=16,
                                     device="cpu")
    nll, ids = [], []
    for step in range(6):
        batch = _to_torch(loader.batch_for_step(step))
        state, metrics = t_steps.train_step(state, batch, cfg)
        nll.append(metrics["per_example_nll"].numpy())
        ids.append(batch["example_ids"].numpy())
    kept = state.reservoir.ids.numpy()
    assert (kept >= 0).sum() == 16  # full after 48 examples
    assert int(state.reservoir.seen) == 48
    nll, ids = np.concatenate(nll), np.concatenate(ids)
    hardest = ids[np.lexsort((ids, -nll))[:16]]
    assert set(kept.tolist()) == set(hardest.tolist())


def test_curation_reconciles_with_analytic_model():
    """The port's host curator: survivors are the exact top-K, payloads
    read back, writes within 35% of eq. 11/12 on a random-order stream,
    and the ledger's writes equal the stats'."""
    k, n, b = 12, 600, 25
    rng = np.random.default_rng(0)
    scores = rng.permutation(n).astype(np.float64)
    pol = placement.Policy(r=n // 3, migrate_at_r=False)
    store = tiers.TieredStore(pol, tiers.HotTier(k, (4,), device="cpu"),
                              tiers.ColdTier())
    cur = TopKCurator(k, store, policy=pol)
    payloads = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    for off in range(0, n, b):
        cur.observe_batch(np.arange(off, off + b), scores[off:off + b],
                          payloads[off:off + b])
    assert set(cur.survivor_ids().tolist()) == set(
        np.argsort(-scores)[:k].tolist())
    for doc, arr in cur.finalize().items():
        np.testing.assert_array_equal(np.asarray(arr), payloads[doc])
    analytic = float(shp.expected_cum_writes(n - 1, k))
    assert abs(cur.stats.writes - analytic) / analytic < 0.35
    assert cur.stats.writes == int(store.ledger.writes.sum())


def test_straggler_detection_and_curator_in_the_loop():
    """Uniform CPU steps raise no straggler; the loop feeds the curator
    every example once with the step's NLL, and it keeps the top-K."""
    cfg, k = _cfg(), 8
    pol = placement.Policy(r=20, migrate_at_r=False)
    store = tiers.TieredStore(pol, tiers.HotTier(k, (SHAPE.seq_len,),
                                                 dtype=torch.int32,
                                                 device="cpu"),
                              tiers.ColdTier())
    cur = TopKCurator(k, store, policy=pol)
    seen = []
    rep = train_loop.run(cfg, _loop_loader(3), loop=train_loop.LoopConfig(
        total_steps=12, ckpt_every=1000, log_every=4, straggler_factor=50.0),
        curator=cur, device="cpu",
        on_metrics=lambda s, m: seen.append((s, sorted(m))))
    assert rep.straggler_steps == 0
    assert cur.stats.observed == 12 * SHAPE.global_batch
    assert cur.stats.writes == int(store.ledger.writes.sum())
    assert [s for s, _ in seen] == [0, 4, 8]
    assert seen[0][1] == ["loss", "median_step_time", "step_time"]
    assert len(cur.survivor_ids()) == k


def test_loop_restores_signal_handlers_and_stops_on_sigterm(tmp_path):
    """SIGTERM during the loop stops it at the step boundary with a final
    checkpoint at the state's step; the previous handlers come back."""
    cfg = _cfg()
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    calls = []

    def on_metrics(step, m):
        calls.append(step)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    mgr = CheckpointManager(str(tmp_path / "c"))
    rep = train_loop.run(cfg, _loop_loader(4), loop=train_loop.LoopConfig(
        total_steps=20, ckpt_every=1000, log_every=1), ckpt=mgr,
        on_metrics=on_metrics, device="cpu")
    assert rep.interrupted and rep.steps_run == 3 and calls == [0, 1, 2]
    assert mgr.latest_step() == 3 == int(rep.final_state.step)
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


def test_train_launcher_drains_on_sigterm(tmp_path):
    """python -m repro_torch.launch.train --device cpu as a subprocess:
    SIGTERM after its first checkpoint; exit 0, and the final checkpoint
    restores at the step the last line names."""
    ckpt = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--steps", "40", "--seq", "128", "--batch", "16",
         "--device", "cpu", "--ckpt-dir", str(ckpt)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.time() + 240
        while not (ckpt / "ckpt_00000020" / "manifest.json").exists():
            assert proc.poll() is None and time.time() < deadline
            time.sleep(0.005)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    last = out.strip().splitlines()[-1]
    assert last.startswith("stopped by a signal at step "), out
    step = int(last.split("at step ")[1].split()[0])
    assert 20 <= step < 40
    mgr = CheckpointManager(str(ckpt))
    assert mgr.latest_step() == step
    state = mgr.restore(t_steps.init_train_state(
        t_configs.get_config(ARCH, reduced=True), reservoir_k=32,
        device="cpu"))
    assert int(state.step) == step


def test_train_launcher_runs_to_the_end_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--steps", "6", "--device", "cpu"],
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith(f"{ARCH}: ") and "on cpu" in lines[0]
    assert lines[-2].startswith("done: loss ")
    assert lines[-1] == "finished at step 6 (6 steps run, resumed from None)"


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_new_modules_import_no_jax_and_no_reference():
    code = (
        "import sys, importlib\n"
        "for n in ['repro_torch.optim', 'repro_torch.optim.adamw',"
        " 'repro_torch.optim.schedules', 'repro_torch.runtime',"
        " 'repro_torch.runtime.steps', 'repro_torch.runtime.train_loop',"
        " 'repro_torch.data.pipeline', 'repro_torch.data.synthetic',"
        " 'repro_torch.launch.train', 'repro_torch.models']:\n"
        "    importlib.import_module(n)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_steps.init_train_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.run(cfg, _loop_loader(0),
                       loop=train_loop.LoopConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_steps.from_reference_train_state(None, cfg)
    from repro_torch.launch import train as t_train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
    assert t_steps.init_train_state(cfg, device="cpu").step.device.type == \
        "cpu"

