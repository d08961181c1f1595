"""The port's entropy/NLL pass (its plain version, which the wrapper runs
on the CPU) and its interestingness scorers against the reference's
Pallas kernel in interpret mode, its jnp oracle and its scorers, on the
same numpy-seeded logits: the sweeps of tests/test_kernels.py (B x V up
to 16 x 32000, float32 and bfloat16, V not a tile multiple), the
extremes, and the scorers of core.interestingness.

Tolerance: 2e-5, that of the reference's own tests (the kernel computes
entropy as lse − Σe·l/Σe, the oracle as −Σp·log p; both agree to about
1e-6 relative, not bitwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interestingness as r_itf
from repro.kernels.entropy_scores import ops as r_ops
from repro.kernels.entropy_scores import ref as r_ref
from repro_torch.core import interestingness as t_itf
from repro_torch.kernels.entropy_scores import ops as t_ops

TOL = 2e-5


def close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,v", [(1, 128), (3, 300), (8, 2048), (5, 5000),
                                 (16, 32000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference(b, v, dtype):
    rng = np.random.default_rng(b * 1000 + v)
    logits = rng.standard_normal((b, v)) * 3
    labels = rng.integers(0, v, size=b).astype(np.int32)
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    tl = torch.tensor(logits).to(getattr(torch, dtype))
    ent, nll = t_ops.entropy_nll(tl, torch.tensor(labels))
    assert ent.dtype == nll.dtype == torch.float32
    jlab = jnp.asarray(labels)
    ent_k, nll_k = r_ops.entropy_nll(jl, jlab, block_b=4, block_v=512)
    ent_r, nll_r = r_ref.entropy_nll(jl, jlab)
    for got, want in ((ent, ent_k), (ent, ent_r), (nll, nll_k),
                      (nll, nll_r)):
        close(got, want)


def test_extremes():
    """Peaked → entropy ≈ 0 and nll ≈ 0 at the peak; uniform → ln V."""
    v = 1024
    peaked = np.zeros((1, v), np.float32)
    peaked[0, 3] = 100.0
    uniform = np.zeros((2, v), np.float32)
    ent_p, nll_p = t_ops.entropy_nll(torch.tensor(peaked),
                                     torch.tensor([3], dtype=torch.int32))
    ent_u, _ = t_ops.entropy_nll(torch.tensor(uniform),
                                 torch.tensor([0, 1], dtype=torch.int32))
    assert float(ent_p[0]) < 1e-3 and abs(float(nll_p[0])) < 1e-3
    np.testing.assert_allclose(ent_u.numpy(), np.log(v), rtol=1e-5)
    r_ent, r_nll = r_ops.entropy_nll(jnp.asarray(peaked),
                                     jnp.asarray([3], jnp.int32))
    close(ent_p, r_ent)
    close(nll_p, r_nll)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_scorers_match_reference(use_kernel, masked):
    rng = np.random.default_rng(0)
    b, s, v = 2, 5, 700
    logits = rng.standard_normal((b, s, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None
    tm = None if mask is None else torch.tensor(mask)
    jm = None if mask is None else jnp.asarray(mask)
    tl, tlab = torch.tensor(logits), torch.tensor(labels)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    close(t_itf.nll_score(tl, tlab, tm, use_kernel=use_kernel),
          r_itf.nll_score(jl, jlab, jm, use_kernel=use_kernel))
    close(t_itf.entropy_score(tl, None, tm, use_kernel=use_kernel),
          r_itf.entropy_score(jl, None, jm, use_kernel=use_kernel))
    close(t_itf.margin_score(tl, tlab, tm), r_itf.margin_score(jl, jlab, jm))


def test_margin_ties_and_registry():
    logits = np.zeros((2, 3, 8), np.float32)
    logits[0, :, 2] = logits[0, :, 5] = 4.0  # tied maximum → margin 0
    logits[1, :, 1] = 3.0
    logits[1, :, 6] = 1.5
    close(t_itf.margin_score(torch.tensor(logits)),
          r_itf.margin_score(jnp.asarray(logits)))
    assert t_itf.get_scorer("entropy") is t_itf.entropy_score
    assert set(t_itf.SCORERS) == set(r_itf.SCORERS)
    with pytest.raises(KeyError):
        t_itf.get_scorer("nope")


def test_detrending_matches_reference():
    rng = np.random.default_rng(4)
    scores = rng.standard_normal(32).astype(np.float32) + 2.0
    close(t_itf.batch_centered(torch.tensor(scores)),
          r_itf.batch_centered(jnp.asarray(scores)), 1e-6)
    ema_t, ema_r = torch.tensor(0.0), jnp.asarray(0.0, jnp.float32)
    for step in range(4):
        rel_t, ema_t = t_itf.ema_relative(torch.tensor(scores + step), ema_t,
                                          torch.tensor(step))
        rel_r, ema_r = r_itf.ema_relative(jnp.asarray(scores + step), ema_r,
                                          jnp.asarray(step))
        close(rel_t, rel_r, 1e-5)
        close(ema_t, ema_r, 1e-5)


def test_random_score_is_uniform_on_the_generator():
    gen = torch.Generator().manual_seed(3)
    s = t_itf.random_score(gen, 4096)
    assert s.shape == (4096,) and s.dtype == torch.float32
    assert 0.0 <= float(s.min()) and float(s.max()) < 1.0
    assert abs(float(s.mean()) - 0.5) < 0.02
    ref = np.asarray(r_itf.random_score(jax.random.PRNGKey(3), 4096))
    assert ref.shape == s.shape and abs(ref.mean() - 0.5) < 0.02
    torch.testing.assert_close(
        s, t_itf.random_score(torch.Generator().manual_seed(3), 4096))


@pytest.mark.parametrize("b,v", [(8, 128256), (8, 49152), (2048, 128256),
                                 (132, 128256), (1, 100), (3, 5001),
                                 (4, 128257), (264, 4096), (1, 1),
                                 (16, 32000), (1, 2048)])
def test_split_columns_cover_each_row_once(b, v):
    """The kernel's spans: [i·width, min((i+1)·width, V)) for i < splits
    cover [0, V) exactly once, none empty, each start 16-byte aligned for
    float32 and bfloat16."""
    splits, width = t_ops.split_columns(b, v)
    spans = [(i * width, min((i + 1) * width, v)) for i in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == v
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
    assert width % t_ops.ALIGN == 0


def test_split_columns_fill_the_card_and_stop_at_one_span():
    # the decode shapes: B alone leaves the card idle, so rows are split
    for b, v in ((8, 128256), (8, 49152)):
        splits, width = t_ops.split_columns(b, v)
        assert b * splits >= t_ops.SMS and width >= t_ops.MIN_WIDTH
    # rows that fill the card take one span each
    assert t_ops.split_columns(2048, 128256) == (1, 128256)
    assert t_ops.split_columns(t_ops.FILL, 128256)[0] == 1
    # V below one span's minimum width: one span
    assert t_ops.split_columns(8, 1000) == (1, 1000)
    assert t_ops.split_columns(1, 5)[0] == 1
