"""Training the soft-capped and the MLA configs, and rematerialisation, on
the CPU: the plain versions of flash_attention's backward under a logit
soft-cap and at MLA's unequal head dims against autograd of the port's
plain forward and ``jax.vjp`` of the reference's ``grouped_attention``;
``loss_and_grads`` under ``cfg.remat`` against the same call without it,
bit for bit, and against ``jax.value_and_grad`` of the reference's
``lm_loss`` under its own ``remat`` (``jax.checkpoint``).

Tolerances, each with its reason:

* backward plain versions: each gradient within 1e-5 of its largest
  magnitude, as ``tests/test_torch_train.py`` holds the uncapped ones
  (float32 sums in another order; the reference scales q before the
  product, the port the product; Delta taken as rowsum(dO∘O) where
  autograd takes rowsum(P∘dP)).
* remat against no remat: bit-equal (the same operations on the same
  inputs, recomputed on the CPU).
* remat against the reference: loss and NLL within rtol 1e-5, each
  gradient leaf within 1e-5 of its largest magnitude, as
  ``test_lm_loss_aux_and_grads_match_reference_moe`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs.base import ShapeConfig as RShape
from repro.data import pipeline as r_pipe
from repro.models import attention as r_attn
from repro.models import lm as r_lm
from repro_torch import configs as t_configs
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.models import lm as t_lm
from repro_torch.runtime import steps as t_steps

R_SHAPE = RShape("t", seq_len=32, global_batch=8, kind="train")

# (B, Sq, Skv, H, KV, hd, causal, window): tests/test_torch_train.py's
# BWD_CASES — groups of 1 to 12, causal and not, windows, Sq < Skv, Sq >
# Skv with rows whose keys are all masked, head dims 16 to 128
BWD_CASES = [(2, 16, 16, 4, 4, 16, True, 0), (1, 24, 24, 8, 2, 16, True, 5),
             (1, 10, 6, 4, 1, 16, True, 0), (1, 8, 20, 4, 4, 32, True, 0),
             (1, 12, 12, 4, 1, 16, False, 4), (1, 14, 9, 4, 4, 16, True, 3),
             (2, 9, 9, 4, 1, 32, False, 0),
             (1, 20, 20, 12, 1, 16, True, 0), (1, 18, 18, 24, 2, 32, True, 0),
             (1, 15, 15, 6, 1, 16, True, 6), (1, 10, 37, 12, 1, 128, True, 0)]
# q is scaled by this, so that the scaled logits reach about ±12 and a cap
# of 5 bites hard (tanh(12 / 5) = 0.98)
CAP_QS = 4.0


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


def _inputs(b, sq, skv, h, kvh, hd, hd_v, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, sq, h, hd), (b, skv, kvh, hd),
                             (b, skv, kvh, hd_v), (b, sq, h, hd_v)))
    return q * np.float32(q_scale), k, v, do


def _check_backward(qn, kn, vn, don, causal, window, softcap, scale=None):
    """reference_backward against autograd through the port's plain
    forward and jax.vjp of the reference's grouped_attention (q row i at
    position i + Skv − Sq, key j at j)."""
    b, sq, h, hd = qn.shape
    skv = kn.shape[1]
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    out = t_fa.flash_attention(q, k, v, **kw)  # the CPU: the plain version
    out.backward(torch.tensor(don))
    with torch.no_grad():
        lse = t_fa.reference_lse(q, k, v, **kw)
        got = t_fa.reference_backward(q, k, v, out, lse, torch.tensor(don),
                                      **kw)
    q_pos = jnp.broadcast_to(jnp.arange(sq) + skv - sq, (b, sq))
    kv_pos = jnp.broadcast_to(jnp.arange(skv), (b, skv))
    r_out, vjp = jax.vjp(
        lambda q_, k_, v_: r_attn.grouped_attention(
            q_, k_, v_, q_pos, kv_pos, causal=causal, window=window,
            softcap=softcap, scale=scale),
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    r_grads = [np.asarray(x) for x in vjp(jnp.asarray(don))]
    assert out.shape == r_out.shape == don.shape
    _rel_close(out.detach().numpy(), np.asarray(r_out), 1e-5, "out")
    for name, a, x, want in zip(("dq", "dk", "dv"), got, (q, k, v), r_grads):
        assert a.shape == x.shape and a.dtype == torch.float32
        _rel_close(a.numpy(), x.grad.numpy(), 1e-5, f"{name} vs autograd")
        _rel_close(a.numpy(), want, 1e-5, f"{name} vs jax.vjp")
    if causal and sq > skv:  # rows with no key: no dq
        assert not got[0][:, :sq - skv].abs().any()
    return got


@pytest.mark.parametrize("softcap", [5.0, 30.0])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", BWD_CASES)
def test_capped_reference_backward_matches_autograd_and_jax(
        b, sq, skv, h, kvh, hd, causal, window, softcap):
    """The plain backward of a soft-capped forward: dS takes 1 − t² of the
    capped logit; masked pairs and rows with no key stay as uncapped."""
    qn, kn, vn, don = _inputs(b, sq, skv, h, kvh, hd, hd,
                              sq * 31 + skv + int(softcap), CAP_QS)
    _check_backward(qn, kn, vn, don, causal, window, softcap)


def test_the_cap_changes_the_gradient():
    """A cap of 5 on logits of about ±12: the capped backward is not the
    uncapped one (the factor 1 − t² and the capped P both bite)."""
    qn, kn, vn, don = _inputs(1, 16, 16, 2, 2, 16, 16, 5, CAP_QS)
    capped = _check_backward(qn, kn, vn, don, True, 0, 5.0)
    plain = _check_backward(qn, kn, vn, don, True, 0, 0.0)
    for a, p in zip(capped, plain):
        assert float((a - p).abs().max()) > 0.1 * float(p.abs().max())


# (B, Sq, Skv, H, hd, hd_v, causal, window): the reduced deepseek-v2 pair
# (24, 16) — causal, ragged Sq < Skv, Sq > Skv with rows whose keys are
# all masked, a window, non-causal — and deepseek-v2's full pair
# (192, 128) at a small sequence; K and V per head, as MLA expands them
MLA_CASES = [(2, 16, 16, 4, 24, 16, True, 0), (1, 9, 21, 2, 24, 16, True, 0),
             (1, 12, 7, 2, 24, 16, True, 0), (2, 20, 20, 4, 24, 16, True, 6),
             (1, 10, 10, 2, 24, 16, False, 0),
             (1, 24, 24, 4, 192, 128, True, 0),
             (1, 8, 19, 2, 192, 128, True, 0)]


@pytest.mark.parametrize("b,sq,skv,h,hd,hd_v,causal,window", MLA_CASES)
def test_unequal_head_dims_reference_backward_matches_autograd_and_jax(
        b, sq, skv, h, hd, hd_v, causal, window):
    """The plain backward at MLA's head dims: dP and Delta over v's head
    dim, dQ and dK over q's and k's; dv takes v's shape."""
    qn, kn, vn, don = _inputs(b, sq, skv, h, h, hd, hd_v, sq + skv + hd)
    got = _check_backward(qn, kn, vn, don, causal, window, 0.0,
                          scale=hd ** -0.5)
    assert got[2].shape == (b, skv, h, hd_v) and got[1].shape[-1] == hd


def test_unequal_head_dims_grouped_reference_backward():
    """(24, 16) with two query heads a KV head: dK and dV are summed over
    the group at their own head dims."""
    qn, kn, vn, don = _inputs(1, 12, 12, 4, 2, 24, 16, 7)
    got = _check_backward(qn, kn, vn, don, True, 0, 0.0)
    assert got[1].shape == (1, 12, 2, 24) and got[2].shape == (1, 12, 2, 16)


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

def _batch(cfg, seed=4):
    batch = r_pipe.StreamLoader(cfg, R_SHAPE, seed=seed).batch_for_step(0)
    batch["labels"][0, :5] = -1  # masked labels count nowhere
    return batch


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "grok-1-314b",
                                  "deepseek-v2-236b"])
def test_remat_is_bit_equal_to_no_remat(arch, use_kernel):
    """loss_and_grads with cfg.remat: each layer's activations recomputed
    in the backward give the same loss, metrics and gradients, bit for
    bit, as the run that keeps them."""
    cfg = t_configs.get_config(arch, reduced=True)
    params = t_lm.init_params(cfg, seed=1, device="cpu")
    batch = {k: torch.as_tensor(x) for k, x in _batch(cfg).items()}
    runs = [t_steps.loss_and_grads(params, cfg.replace(remat=remat), batch,
                                   0.5, use_kernel=use_kernel)
            for remat in (False, True)]
    (l0, m0, g0), (l1, m1, g1) = runs
    assert torch.equal(l0, l1)
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    pairs = list(zip(_leaves_with_paths(g0), _leaves_with_paths(g1)))
    assert pairs
    for (path, a), (path1, b) in pairs:
        assert path == path1 and torch.equal(a, b), path


def test_remat_checkpoints_each_layer_only_while_recording(monkeypatch):
    """The layer loop calls torch.utils.checkpoint once a layer when
    cfg.remat is set and autograd records, and never under no_grad, at
    prefill (caches written in place) or without remat."""
    cfg = t_configs.get_config("llama3.2-1b", reduced=True)
    params = t_lm.init_params(cfg, seed=1, device="cpu")
    tokens = torch.as_tensor(_batch(cfg)["tokens"][:2, :8])
    calls = []
    real = t_lm.checkpoint

    def counted(*args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*args, **kw)

    monkeypatch.setattr(t_lm, "checkpoint", counted)
    remat = cfg.replace(remat=True)
    leaf = params["final_norm"]["scale"]
    leaf.requires_grad_(True)
    logits, _ = t_lm.forward(params, remat, {"tokens": tokens})
    assert calls == [False] * cfg.n_layers and logits.requires_grad
    calls.clear()
    with torch.no_grad():
        t_lm.forward(params, remat, {"tokens": tokens})
    t_lm.forward(params, cfg, {"tokens": tokens})
    cache = t_lm.init_cache(remat, 2, 16, device="cpu")
    t_lm.prefill(params, remat, {"tokens": tokens}, cache)
    assert calls == []
    leaf.requires_grad_(False)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_remat_grok_matches_reference_checkpoint(use_kernel):
    """Reduced grok-1-314b (soft-capped attention, two MoE layers) with
    cfg.remat on both sides: the port's checkpointed layers against
    jax.value_and_grad of the reference's lm_loss through its
    jax.checkpoint'ed scan body — loss, aux, NLL and every gradient."""
    cfg = r_configs.get_config("grok-1-314b", reduced=True).replace(
        remat=True)
    tcfg = t_configs.get_config("grok-1-314b", reduced=True).replace(
        remat=True)
    params = r_lm.init_params(cfg, jax.random.PRNGKey(3))
    batch = _batch(cfg)
    (r_loss, r_met), r_grads = jax.value_and_grad(
        lambda p: r_lm.lm_loss(p, cfg, jax.tree.map(jnp.asarray, batch),
                               aux_weight=0.5), has_aux=True)(params)
    tparams = t_lm.from_reference_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    loss, met, grads = t_steps.loss_and_grads(
        tparams, tcfg, {k: torch.as_tensor(x) for k, x in batch.items()},
        0.5, use_kernel=use_kernel)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    for key in ("loss", "aux_loss", "per_example_nll", "tokens"):
        np.testing.assert_allclose(met[key].numpy(), np.asarray(r_met[key]),
                                   rtol=1e-5)
    want = dict(_leaves_with_paths(t_lm.from_reference_params(
        jax.tree.map(np.asarray, r_grads), tcfg, device="cpu")))
    assert want.keys() == dict(_leaves_with_paths(grads)).keys()
    for path, g in _leaves_with_paths(grads):
        assert g.shape == want[path].shape and bool(g.abs().any()), path
        _rel_close(g.numpy(), want[path].numpy(), 1e-5, str(path))
