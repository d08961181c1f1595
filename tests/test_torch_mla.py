"""``repro_torch.models.attention``'s MLA (DeepSeek-V2's multi-head latent
attention) against the reference's ``repro.models.attention`` on the CPU:
the parameter shapes, ``_mla_q`` and ``_mla_latent`` with and without the
query's low-rank branch, ``mla_forward_expanded`` through the
flash_attention kernel's plain version (q/k head dim nope + rope, v head
dim v_head_dim) and through the plain grouped attention,
``_mla_attend_latent_chunked`` past one chunk with a padded tail (and the
kernel's plain version held to it), and ``mla_forward_absorbed`` with its
latent cache after each step: written slots, positions and a rolling
slot that wraps.

Inputs come from a numpy seed, weights from the reference's
``mla_params`` carried across as numpy arrays. Tolerance: float32 within
2e-5 absolute and relative (products and softmax sums in another order
on another backend); cache positions exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import attention as r_attn
from repro_torch import configs as t_configs
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.models import attention as t_attn

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "deepseek-v2-236b"


def cfgs(q_lora: bool):
    """The reduced deepseek config (4 heads, kv_lora 16, q_lora 24, nope
    16, rope 8, v 16), or the same with the single ``wq``."""
    r = r_configs.get_config(ARCH, reduced=True)
    t = t_configs.get_config(ARCH, reduced=True)
    if not q_lora:
        r, t = r.replace(q_lora_rank=0), t.replace(q_lora_rank=0)
    return r, t


def setup(q_lora: bool, seed=0):
    r, t = cfgs(q_lora)
    p = r_attn.mla_params(jax.random.PRNGKey(seed), r, jnp.float32)
    # nonzero norm scales, so that the (1 + scale) factor is exercised
    rng = np.random.default_rng(seed + 100)
    p = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             if k.endswith("norm") else v) for k, v in p.items()}
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    return r, t, p, tp


def inputs(cfg, b, s, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return x, pos


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_shapes_equal_reference_params(q_lora):
    r, t, p, _ = setup(q_lora)
    assert t_attn.mla_shapes(t) == {k: v.shape for k, v in p.items()}
    ours = t_attn.mla_params(torch.Generator().manual_seed(0), t,
                             torch.float32)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in p.items()}
    assert not ours["kv_norm"].any()


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_q_and_latent_match_reference(q_lora):
    r, t, p, tp = setup(q_lora)
    x, pos = inputs(r, 2, 11)
    rqn, rqr = r_attn._mla_q(p, jnp.asarray(x), jnp.asarray(pos), r)
    qn, qr = t_attn._mla_q(tp, torch.tensor(x), torch.tensor(pos), t)
    assert qn.shape == (2, 11, t.n_heads, t.qk_nope_head_dim)
    assert qr.shape == (2, 11, t.n_heads, t.qk_rope_head_dim)
    close(qn, rqn)
    close(qr, rqr)
    rckv, rkr = r_attn._mla_latent(p, jnp.asarray(x), jnp.asarray(pos), r)
    ckv, kr = t_attn._mla_latent(tp, torch.tensor(x), torch.tensor(pos), t)
    assert ckv.shape == (2, 11, t.kv_lora_rank)
    assert kr.shape == (2, 11, t.qk_rope_head_dim)
    close(ckv, rckv)
    close(kr, rkr)


@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_expanded_matches_reference(q_lora, flash, causal):
    """flash=True on the CPU runs the kernel's plain version at head dims
    (24, 16); flash=False the plain grouped attention."""
    r, t, p, tp = setup(q_lora)
    x, pos = inputs(r, 2, 13)
    want = r_attn.mla_forward_expanded(p, jnp.asarray(x), jnp.asarray(pos), r,
                                       causal=causal)
    got = t_attn.mla_forward_expanded(tp, torch.tensor(x), torch.tensor(pos),
                                      t, causal=causal, flash=flash)
    assert got.shape == (2, 13, t.d_model)
    close(got, want)


def test_mla_expanded_attends_at_unequal_head_dims(monkeypatch):
    """With flash=True the expanded form hands flash_attention q and k of
    head dim nope + rope and v of v_head_dim, at scale 1/sqrt(nope +
    rope)."""
    r, t, p, tp = setup(True)
    x, pos = inputs(r, 1, 9)
    seen = []
    orig = t_fa.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape, k.shape, v.shape, kw))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(t_fa, "flash_attention", spy)
    t_attn.mla_forward_expanded(tp, torch.tensor(x), torch.tensor(pos), t,
                                flash=True)
    qk = t.qk_nope_head_dim + t.qk_rope_head_dim
    (qs, ks, vs, kw), = seen
    assert qs == ks == (1, 9, t.n_heads, qk)
    assert vs == (1, 9, t.n_heads, t.v_head_dim)
    assert kw["scale"] == 1.0 / math.sqrt(qk) and kw["window"] == 0


@pytest.mark.parametrize("s,chunk", [(20, 8), (16, 8), (5, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_attend_latent_chunked_matches_reference(s, chunk, causal):
    """The latent-chunked scan at chunks of 8: past one chunk with a padded
    tail (20), whole chunks (16) and one short chunk (5); the kernel's
    plain version on the same latents, expanded, agrees with it."""
    r, t, p, tp = setup(True)
    x, pos = inputs(r, 2, s, seed=s)
    rq = jnp.concatenate(r_attn._mla_q(p, jnp.asarray(x), jnp.asarray(pos),
                                       r), -1)
    rckv, rkr = r_attn._mla_latent(p, jnp.asarray(x), jnp.asarray(pos), r)
    scale = 1.0 / math.sqrt(r.qk_nope_head_dim + r.qk_rope_head_dim)
    want = r_attn._mla_attend_latent_chunked(
        rq, rckv, rkr, p["wkv_b"], jnp.asarray(pos), r, causal=causal,
        scale=scale, chunk=chunk)
    tq = torch.cat(t_attn._mla_q(tp, torch.tensor(x), torch.tensor(pos), t),
                   -1)
    ckv, kr = t_attn._mla_latent(tp, torch.tensor(x), torch.tensor(pos), t)
    got = t_attn._mla_attend_latent_chunked(
        tq, ckv, kr, tp["wkv_b"], torch.tensor(pos), t, causal=causal,
        scale=scale, chunk=chunk)
    assert got.shape == (2, s, t.n_heads, t.v_head_dim)
    close(got, want)
    nope = t.qk_nope_head_dim
    kv = torch.einsum("bsr,rhk->bshk", ckv, tp["wkv_b"])
    k = torch.cat([kv[..., :nope], kr[:, :, None].expand(
        *kv.shape[:3], kr.shape[-1])], -1)
    flash = t_fa.flash_attention(tq, k, kv[..., nope:], causal=causal,
                                 scale=scale)
    close(flash, got)


def test_mla_forward_absorbed_and_cache_match_reference():
    """A cache of 8 slots: positions 0-4 written as a prefill writes them,
    then absorbed decode steps at positions 5-11, the last four wrapping
    into slots 0-3. After each step the output, the latents, the RoPE keys
    and the positions equal the reference's; the port's cache is updated
    in place."""
    r, t, p, tp = setup(True)
    b, w, s = 2, 8, 12
    x, pos = inputs(r, b, s, seed=7)
    rc = r_attn.init_mla_cache(b, w, r, jnp.float32)
    tc = t_attn.init_mla_cache(b, w, t, torch.float32)
    assert (tuple(tc.ckv.shape), tuple(tc.krope.shape),
            tuple(tc.pos.shape)) == (rc.ckv.shape, rc.krope.shape,
                                     rc.pos.shape)
    assert bool((tc.pos == -1).all()) and tc.pos.dtype == torch.int32
    # the prompt's latents, as models.blocks writes them at prefill
    rckv, rkr = r_attn._mla_latent(p, jnp.asarray(x[:, :5]),
                                   jnp.asarray(pos[:, :5]), r)
    bidx = jnp.arange(b)[:, None]
    rc = r_attn.MLACache(ckv=rc.ckv.at[bidx, pos[:, :5]].set(rckv),
                         krope=rc.krope.at[bidx, pos[:, :5]].set(rkr),
                         pos=rc.pos.at[bidx, pos[:, :5]].set(pos[:, :5]))
    ckv, kr = t_attn._mla_latent(tp, torch.tensor(x[:, :5]),
                                 torch.tensor(pos[:, :5]), t)
    tc = t_attn.cache_write(tc, ckv, kr, torch.tensor(pos[:, :5]))
    for i in range(5, s):
        xi, pi = x[:, i:i + 1], pos[:, i:i + 1]
        want, rc = r_attn.mla_forward_absorbed(p, jnp.asarray(xi),
                                               jnp.asarray(pi), r, rc)
        got, tc2 = t_attn.mla_forward_absorbed(tp, torch.tensor(xi),
                                               torch.tensor(pi), t, tc)
        assert tc2.ckv is tc.ckv  # written in place
        close(got, want)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(rc.pos))
        close(tc.ckv, rc.ckv)
        close(tc.krope, rc.krope)
    assert tc.pos[0].tolist() == [8, 9, 10, 11, 4, 5, 6, 7]


def test_mla_cache_write_keeps_the_last_window_of_a_long_prompt():
    _, t, _, _ = setup(True)
    c = t_attn.init_mla_cache(1, 4, t, torch.float32)
    ckv = torch.arange(6.0)[None, :, None].expand(1, 6, t.kv_lora_rank)
    kr = torch.zeros((1, 6, t.qk_rope_head_dim))
    t_attn.cache_write(c, ckv, kr, torch.arange(6)[None])
    assert c.pos[0].tolist() == [4, 5, 2, 3]
    assert c.ckv[0, :, 0].tolist() == [4.0, 5.0, 2.0, 3.0]
