"""The port's Mixture-of-Experts (``repro_torch.models.ffn``) and its
soft-capped attention (``repro_torch.models.attention``) against the
reference's ``repro.models.ffn`` and ``repro.models.attention`` on the
CPU.

Routing: ``_capacity`` over a grid; the combine tensor bit for bit from
the same router probabilities (renormalised or not, drops past capacity,
tied probabilities taken lower expert first, a gate that underflows to
0), and from the same float32 logits with the same routing and gates
within 1e-6 relative (the two softmaxes' ``exp`` differ by an ulp);
where ties or underflow make the softmax exact, bit for bit from the
logits too. ``moe_forward``'s output and aux and ``load_balance_loss``
within 2e-5 relative and absolute (tests/test_torch_models.py's TOL: the
expert products sum in another order on another backend), with the
reference's weights carried across. Attention: ``grouped_attention`` and
``chunked_attention`` with ``softcap`` against the reference's, within
the same 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import attention as r_attn
from repro.models import ffn as r_ffn
from repro_torch import configs as t_configs
from repro_torch.models import attention as t_attn
from repro_torch.models import ffn as t_ffn

TOL = dict(rtol=2e-5, atol=2e-5)


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def same_bits(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def cfgs(arch="grok-1-314b", **kw):
    r = r_configs.get_config(arch, reduced=True)
    t = t_configs.get_config(arch, reduced=True)
    return (dataclasses.replace(r, **kw) if kw else r,
            dataclasses.replace(t, **kw) if kw else t)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("group", [1, 7, 16, 512])
@pytest.mark.parametrize("top_k,n_experts", [(1, 4), (2, 4), (2, 8), (6, 160)])
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0, 4.0])
def test_capacity_equals_reference(group, top_k, n_experts, factor):
    assert t_ffn._capacity(group, top_k, n_experts, factor) == \
        r_ffn._capacity(group, top_k, n_experts, factor)


def logits_case(kind, seed=0):
    """(G, g, E) float32 router logits of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.standard_normal((3, 16, 4)) * 2).astype(np.float32)
    if kind == "skewed":  # most tokens want expert 2: drops at capacity
        x = rng.standard_normal((2, 16, 4)).astype(np.float32)
        x[..., 2] += 3.0
        return x
    if kind == "tied":  # uniform rows (padding's zero logits) and pairs
        x = rng.standard_normal((2, 16, 4)).astype(np.float32)
        x[:, :6] = 0.0
        x[:, 6:10, 1] = x[:, 6:10, 3] = 5.0
        return x
    if kind == "zero gate":  # every other expert's probability underflows
        x = np.full((2, 16, 4), -200.0, np.float32)
        x[..., 0] = 0.0
        x[:, 8:, 0], x[:, 8:, 3] = -200.0, 0.0
        return x
    raise ValueError(kind)


# (kind, top_k, capacity, renorm)
DISPATCH_CASES = [("normal", 2, 16, True), ("normal", 2, 16, False),
                  ("normal", 1, 8, True), ("skewed", 2, 6, True),
                  ("skewed", 2, 3, False), ("tied", 2, 16, True),
                  ("tied", 2, 5, True), ("zero gate", 2, 16, True),
                  ("zero gate", 2, 9, False)]


@pytest.mark.parametrize("kind,top_k,cap,renorm", DISPATCH_CASES)
def test_moe_dispatch_equals_reference(kind, top_k, cap, renorm):
    """From the reference's own probabilities the port's route gives the
    reference's combine bit for bit; from the same logits the dispatch
    mask is equal and the gates within 1e-6 relative (bit for bit where
    the softmax is exact: uniform and underflowing rows)."""
    x = logits_case(kind)
    want = np.asarray(r_ffn.moe_dispatch(jnp.asarray(x), top_k, cap, renorm))
    probs = torch.tensor(np.asarray(jax.nn.softmax(jnp.asarray(x), -1)))
    route = t_ffn.moe_route(probs, top_k, cap, renorm)
    same_bits(t_ffn.combine_of(route, x.shape[-1], cap), want)
    got = t_ffn.moe_dispatch(torch.tensor(x), top_k, cap, renorm).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if kind == "tied":  # the uniform rows' softmax is exact
        same_bits(got[:, :6], want[:, :6])
    if kind == "zero gate":
        same_bits(got, want)
    if kind in ("skewed",):  # capacity below demand: choices are dropped
        assert int((want > 0).sum()) < x.shape[0] * x.shape[1] * top_k


def test_route_slots_are_choice_major_then_token_major():
    """Slots are counted per expert, choice-major, then token-major: with
    every token's choices (0, 1) each expert's slots run 0..3 in token
    order; tied probabilities take the lower expert first, and capacity 3
    drops the fourth token's choices; an expert chosen second by an
    earlier token and first by a later one gives the first choice the
    lower slot."""
    probs = torch.tensor([[[0.6, 0.3, 0.1]] * 4], dtype=torch.float32)
    r = t_ffn.moe_route(probs, 2, 6, renorm=False)
    assert r.experts[0].tolist() == [[0, 1]] * 4
    assert r.slots[0].tolist() == [[0, 0], [1, 1], [2, 2], [3, 3]]
    assert bool(r.sent.all())
    probs = torch.tensor([[[0.45, 0.45, 0.1]] * 4], dtype=torch.float32)
    r = t_ffn.moe_route(probs, 2, 3, renorm=False)
    assert r.experts[0].tolist() == [[0, 1]] * 4
    assert r.slots[0].tolist() == [[0, 0], [1, 1], [2, 2], [3, 3]]
    assert r.sent[0].tolist() == [[True, True]] * 3 + [[False, False]]
    probs = torch.tensor([[[0.5, 0.4, 0.1], [0.4, 0.5, 0.1]]])
    r = t_ffn.moe_route(probs, 2, 4, renorm=False)
    assert r.experts[0].tolist() == [[0, 1], [1, 0]]
    assert r.slots[0].tolist() == [[0, 1], [0, 1]]


def test_zero_gate_is_not_sent():
    """A kept choice whose gate is 0 takes its slot but is not dispatched
    (the reference dispatches where combine > 0)."""
    x = torch.tensor(logits_case("zero gate"))
    r = t_ffn.moe_route(torch.softmax(x, -1), 2, 16, renorm=True)
    assert bool((r.gates[..., 1] == 0).all())
    assert bool((r.slots < 16).all())
    assert bool(r.sent[..., 0].all()) and not bool(r.sent[..., 1].any())


# (label, config changes, tokens (B, S))
FORWARD_CASES = [
    ("reduced grok, dropless", {}, (2, 24)),
    ("shared expert (the deepseek path)", {"n_shared_experts": 1}, (2, 16)),
    ("T not a multiple of the group: padding", {}, (3, 7)),
    ("capacity factor 1.25: drops", {"capacity_factor": 1.25}, (2, 24)),
    ("capacity factor 1.25, padding", {"capacity_factor": 1.25}, (1, 21)),
    ("no renorm, top-1", {"router_scale": False, "top_k_experts": 1},
     (2, 16)),
    ("(T, D) input", {}, (20,)),
]


@pytest.mark.parametrize("label,changes,shape", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_moe_forward_equals_reference(label, changes, shape):
    rcfg, tcfg = cfgs(**changes)
    p = r_ffn.moe_params(jax.random.PRNGKey(5), rcfg, jnp.float32)
    tp = to_torch(p)
    assert set(tp) == set(t_ffn.moe_shapes(tcfg))
    for name, s in t_ffn.moe_shapes(tcfg).items():
        if name != "shared":
            assert tuple(tp[name].shape) == s
    x = np.random.default_rng(6).standard_normal(
        (*shape, rcfg.d_model)).astype(np.float32)
    y_r, aux_r = r_ffn.moe_forward(p, jnp.asarray(x), rcfg)
    y, aux = t_ffn.moe_forward(tp, torch.tensor(x), tcfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    close(y, y_r)
    close(aux, aux_r)
    # the padded group's zero rows take slots: with drops they push real
    # tokens' second choices out of experts 0 and 1, as in the reference
    t = int(np.prod(shape))
    g = min(tcfg.moe_group_size, t)
    if t % g:
        xg = torch.nn.functional.pad(torch.tensor(x).reshape(t, -1),
                                     (0, 0, 0, g - t % g))
        probs = torch.softmax(xg.reshape(-1, g, tcfg.d_model)
                              @ tp["router"], -1)
        r = t_ffn.moe_route(probs, tcfg.top_k_experts, 1, True)
        assert r.experts[-1, -1].tolist()[:2] == [0, 1][:tcfg.top_k_experts]


def test_moe_forward_drops_differ_from_dropless():
    """At capacity factor 1.25 some choices are dropped, so the output
    differs from the dropless one on those tokens only."""
    rcfg, tcfg = cfgs(capacity_factor=1.25)
    _, free = cfgs()
    tp = to_torch(r_ffn.moe_params(jax.random.PRNGKey(5), rcfg, jnp.float32))
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (2, 24, rcfg.d_model)).astype(np.float32))
    y, _ = t_ffn.moe_forward(tp, x, tcfg)
    y_free, _ = t_ffn.moe_forward(tp, x, free)
    moved = (y - y_free).abs().amax(-1) > 0
    assert 0 < int(moved.sum()) < moved.numel()


def test_moe_params_router_is_float32_and_fan_in_axis_1():
    _, tcfg = cfgs(n_shared_experts=1)
    gen = torch.Generator().manual_seed(0)
    p = t_ffn.moe_params(gen, tcfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["w_up"].dtype == p["shared"]["w_up"].dtype == torch.bfloat16
    d = tcfg.d_model
    # truncated normal over the fan-in (d_model for up/gate, d_ff for down)
    assert float(p["w_up"].float().abs().max()) <= 2 / np.sqrt(d) * 1.01
    assert float(p["w_down"].float().abs().max()) <= \
        2 / np.sqrt(tcfg.d_ff_expert) * 1.01
    assert p["shared"]["w_gate"].shape == (d, tcfg.d_ff_expert)


@pytest.mark.parametrize("kind", ["normal", "skewed", "tied"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_load_balance_loss_equals_reference(kind, top_k):
    x = logits_case(kind, seed=2)
    close(t_ffn.load_balance_loss(torch.tensor(x), top_k),
          r_ffn.load_balance_loss(jnp.asarray(x), top_k))


# ---------------------------------------------------------------------------
# soft-capped attention
# ---------------------------------------------------------------------------

def attn_inputs(b, sq, skv, h, kvh, hd, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qpos = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32), (b, sq))
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv))
    return (f(b, sq, h, hd) * q_scale, f(b, skv, kvh, hd), f(b, skv, kvh, hd),
            np.ascontiguousarray(qpos), np.ascontiguousarray(kpos))


# (b, sq, skv, h, kvh, hd, causal, window, softcap, q scale)
SOFTCAP_CASES = [(2, 24, 24, 4, 2, 16, True, 0, 30.0, 1.0),
                 (1, 20, 20, 6, 2, 16, True, 7, 5.0, 8.0),   # window, bites
                 (1, 12, 40, 6, 2, 32, True, 0, 5.0, 8.0),   # odd group 3
                 (1, 16, 16, 5, 1, 16, False, 0, 2.0, 8.0),  # odd group 5
                 (2, 24, 24, 4, 2, 16, True, 0, 0.0, 1.0)]   # no cap


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window,cap,qs",
                         SOFTCAP_CASES)
def test_grouped_attention_softcap_equals_reference(b, sq, skv, h, kvh, hd,
                                                    causal, window, cap, qs):
    q, k, v, qp, kp = attn_inputs(b, sq, skv, h, kvh, hd, sq + skv, qs)
    kw = dict(causal=causal, window=window, softcap=cap)
    want = r_attn.grouped_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                    **kw)
    got = t_attn.grouped_attention(*map(torch.tensor, (q, k, v, qp, kp)),
                                   **kw)
    close(got, want)
    if cap:  # the cap bites: the uncapped attention differs
        plain = t_attn.grouped_attention(
            *map(torch.tensor, (q, k, v, qp, kp)), causal=causal,
            window=window)
        assert float((plain - got).abs().max()) > 1e-3


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window,cap,qs",
                         SOFTCAP_CASES)
def test_chunked_attention_softcap_equals_reference(b, sq, skv, h, kvh, hd,
                                                    causal, window, cap, qs):
    """The scan over chunks of 16 keys (Skv past the chunk: the last one
    padded with masked keys) against the reference's scan and against the
    port's dense path."""
    q, k, v, qp, kp = attn_inputs(b, sq, skv, h, kvh, hd, sq + skv + 1, qs)
    kw = dict(causal=causal, window=window, softcap=cap, chunk=16)
    want = r_attn.chunked_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                    **kw)
    args = tuple(map(torch.tensor, (q, k, v, qp, kp)))
    got = t_attn.chunked_attention(*args, **kw)
    close(got, want)
    close(got, t_attn.grouped_attention(*args, causal=causal, window=window,
                                        softcap=cap))


def test_chunked_attention_default_chunk_and_bfloat16():
    """The default chunk of 1024 over 1100 keys, bfloat16 inputs (output
    in v's dtype) against the reference within 2e-2."""
    q, k, v, qp, kp = attn_inputs(1, 8, 1100, 2, 1, 16, 9, 4.0)
    kw = dict(causal=True, window=0, softcap=5.0)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = r_attn.chunked_attention(bf(q), bf(k), bf(v), jnp.asarray(qp),
                                    jnp.asarray(kp), **kw)
    tb = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    got = t_attn.chunked_attention(tb(q), tb(k), tb(v), torch.tensor(qp),
                                   torch.tensor(kp), **kw)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)
