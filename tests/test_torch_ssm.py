"""The port's SSD mixer (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the CPU: the chunked scan with and
without a carried state (a padded tail, a whole chunk, a short prompt),
the conv and head split, ``ssm_forward`` over a sequence and one decode
step from a carried ``SSMState``, and the state's layout; then the scan
against the decode recurrence at chunk 128, where ``exp`` above the
diagonal would overflow, with finite gradients.

Inputs come from numpy seeds, weights from the reference's
``ssm_params`` carried across. Tolerance: 2e-5 relative and absolute
(tests/test_torch_models.py's TOL) — the einsums run as matmuls summed
in another order on another backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import ssm as r_ssm
from repro_torch import configs as t_configs
from repro_torch.models import ssm as t_ssm

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["mamba2-2.7b", "hymba-1.5b"]


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def scan_inputs(b, s, h, hd, n, seed, init=False):
    """xh, B, C, dt (a softplus: positive), log_decay = dt · a, and an
    optional carried state, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    dt = np.log1p(np.exp(f(b, s, h))).astype(np.float32)
    a = -np.exp(rng.uniform(-1, 1, h)).astype(np.float32)
    out = [f(b, s, h, hd), f(b, s, h, n), f(b, s, h, n), dt,
           (dt * a).astype(np.float32)]
    return out, (f(b, h, hd, n) if init else None)


def params_for(arch, seed=0):
    cfg = r_configs.get_config(arch, reduced=True)
    p = r_ssm.ssm_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed + 10)
    # move a_log, dt_bias, d_skip and the norm off their constant inits
    p = dict(p, a_log=jnp.asarray(rng.uniform(-1, 1, p["a_log"].shape),
                                  jnp.float32),
             dt_bias=jnp.asarray(rng.uniform(-1, 1, p["dt_bias"].shape),
                                 jnp.float32),
             d_skip=jnp.asarray(rng.uniform(0, 2, p["d_skip"].shape),
                                jnp.float32),
             conv_b=jnp.asarray(rng.standard_normal(p["conv_b"].shape) * 0.1,
                                jnp.float32),
             out_norm=jnp.asarray(rng.standard_normal(p["out_norm"].shape)
                                  * 0.1, jnp.float32))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    return cfg, t_configs.get_config(arch, reduced=True), p, tp


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s,chunk", [(20, 16), (16, 16), (5, 16)])
def test_ssd_chunked_matches_reference(s, chunk, init):
    xs, st = scan_inputs(2, s, 3, 4, 5, seed=s + 7 * init, init=init)
    r_y, r_final = r_ssm.ssd_chunked(*map(jnp.asarray, xs), chunk,
                                     None if st is None else jnp.asarray(st))
    t_y, t_final = t_ssm.ssd_chunked(*map(torch.tensor, xs), chunk,
                                     None if st is None else torch.tensor(st))
    assert t_y.shape == (2, s, 3, 4) and t_final.shape == (2, 3, 4, 5)
    assert t_y.dtype == t_final.dtype == torch.float32
    close(t_y, r_y)
    close(t_final, r_final)


def test_ssd_chunked_padded_tail_leaves_the_state_alone():
    """S % chunk != 0: the padded steps after the softplus have dt = 0 and
    decay 1, so the final state is the state after the last real step —
    the same as scanning the S steps with a chunk that divides S."""
    xs, st = scan_inputs(1, 20, 2, 4, 3, seed=11, init=True)
    t = [torch.tensor(x) for x in xs]
    _, padded = t_ssm.ssd_chunked(*t, 16, torch.tensor(st))
    _, exact = t_ssm.ssd_chunked(*t, 20, torch.tensor(st))
    torch.testing.assert_close(padded, exact, **TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_conv_and_heads_match_reference(arch, with_state):
    cfg, tcfg, p, tp = params_for(arch)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    z, xbc, dt = r_ssm._split_in(p, jnp.asarray(x), cfg)
    tz, txbc, tdt = t_ssm._split_in(tp, torch.tensor(x), tcfg)
    for a, b in ((tz, z), (txbc, xbc), (tdt, dt)):
        close(a, b)
    state = (rng.standard_normal((2, cfg.ssm_conv_width - 1, xbc.shape[-1]))
             .astype(np.float32) if with_state else None)
    out, new = r_ssm._causal_conv(xbc, p["conv_w"], p["conv_b"],
                                  None if state is None
                                  else jnp.asarray(state))
    tout, tnew = t_ssm._causal_conv(torch.tensor(np.asarray(xbc)),
                                    tp["conv_w"], tp["conv_b"],
                                    None if state is None
                                    else torch.tensor(state))
    close(tout, out)
    close(tnew, new)
    ref = r_ssm._heads(out, dt, p, cfg)
    got = t_ssm._heads(torch.tensor(np.asarray(out)),
                       torch.tensor(np.asarray(dt)), tp, tcfg)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_ssm_state_matches_reference(arch):
    cfg = r_configs.get_config(arch, reduced=True)
    ref = r_ssm.init_ssm_state(3, cfg, jnp.bfloat16)
    got = t_ssm.init_ssm_state(3, t_configs.get_config(arch, reduced=True),
                               torch.bfloat16, device="cpu")
    assert tuple(got.state.shape) == ref.state.shape
    assert tuple(got.conv.shape) == ref.conv.shape
    assert got.state.dtype == torch.float32
    assert got.conv.dtype == torch.bfloat16
    assert not got.state.any() and not got.conv.any()
    assert t_ssm.ssm_shapes(t_configs.get_config(arch, reduced=True)) == {
        k: v.shape for k, v in r_ssm.ssm_params(
            jax.random.PRNGKey(0), cfg, jnp.float32).items()}


@pytest.mark.parametrize("s", [20, 16, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_and_decode_step_match_reference(arch, s):
    """A sequence of s tokens with the state returned, then one decode
    step (S = 1) from the carried SSMState: the output and both state
    fields against the reference's."""
    cfg, tcfg, p, tp = params_for(arch, seed=s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    r_out, r_st = r_ssm.ssm_forward(p, jnp.asarray(x), cfg,
                                    return_state=True)
    t_out, t_st = t_ssm.ssm_forward(tp, torch.tensor(x), tcfg,
                                    return_state=True)
    close(t_out, r_out)
    close(t_st.state, r_st.state)
    close(t_st.conv, r_st.conv)
    # the carried conv state owns its storage: a view would pin the
    # layer's whole (B, K-1+S, C) conv input for the life of the cache
    assert t_st.conv.untyped_storage().nbytes() == \
        t_st.conv.numel() * t_st.conv.element_size()
    r_out, r_st = r_ssm.ssm_forward(p, jnp.asarray(x1), cfg, r_st,
                                    return_state=True)
    t_out, t_st = t_ssm.ssm_forward(tp, torch.tensor(x1), tcfg, t_st,
                                    return_state=True)
    close(t_out, r_out)
    close(t_st.state, r_st.state)
    close(t_st.conv, r_st.conv)
    out, none = t_ssm.ssm_forward(tp, torch.tensor(x), tcfg)
    assert none is None and out.shape == (2, s, cfg.d_model)


def test_long_chunk_scan_equals_recurrence_with_finite_grads():
    """Chunk 128 with a per-step log-decay of -0.75: cs[t] − cs[s] above
    the diagonal reaches 95, past float32's exp limit of 88.7 (a_log = 0
    gives about -0.69 a step). The scan must equal the float64
    step-by-step recurrence, and its gradients must be finite (the −inf
    is set before the exp)."""
    b, s, h, hd, n = 1, 128, 2, 4, 3
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((b, s, h, hd), (b, s, h, n), (b, s, h, n))]
    dt = np.full((b, s, h), 0.75, np.float32)
    t = [torch.tensor(x, requires_grad=True)
         for x in xs + [dt, (-dt).astype(np.float32)]]
    y, final = t_ssm.ssd_chunked(*t, 128)
    # the recurrence in float64: st ← e^{ld} st + dt x ⊗ b; y = st · c
    x, bb, cc = (v.astype(np.float64) for v in xs)
    st = np.zeros((b, h, hd, n))
    want = np.zeros((b, s, h, hd))
    for i in range(s):
        st = (np.exp(-dt[:, i, :, None, None].astype(np.float64)) * st
              + (x[:, i] * dt[:, i, :, None])[..., None] * bb[:, i, :, None])
        want[:, i] = np.einsum("bhdn,bhn->bhd", st, cc[:, i])
    close(y.detach(), want)
    close(final.detach(), st)
    assert not torch.isfinite(torch.exp(torch.tensor(127 * 0.75)))
    (y.sum() + final.sum()).backward()
    for v in t:
        assert torch.isfinite(v.grad).all()
