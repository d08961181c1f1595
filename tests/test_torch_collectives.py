"""The port's int8 error-feedback collectives
(``repro_torch.parallel.collectives``) against the reference's
``repro.parallel.collectives``.

``quantize_int8`` is held bit for bit (the int8 payload and the float32
scale's bits), ties at .5 included: ``torch.round`` and ``jnp.round``
both round half to even. One shard is held bit for bit to the reference
under ``shard_map`` on a (1,) mesh, round after round of error feedback;
the telescoping property is checked as ``tests/test_collectives.py``
checks it. Four shards are held to a float64 plain mean within the bound
the algebra gives: each shard's residual is at most half its scale, and
the mean scale replaces each shard's own, so the mean is off by at most
Σ(scale_i / 2 + 127·|s̄ − scale_i|) / n (plus float32 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.5 exports it at top level
    from jax import shard_map
except (ImportError, AttributeError):
    from jax.experimental.shard_map import shard_map

from repro.parallel import collectives as r_coll
from repro_torch.parallel import collectives as t_coll


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


CASES = {
    "normal": lambda rng: rng.standard_normal(1000) * 0.01,
    "wide": lambda rng: rng.standard_normal(4096) * 1e3,
    "tiny": lambda rng: rng.standard_normal(257) * 1e-30,
    "zeros": lambda rng: np.zeros(64),
    "matrix": lambda rng: rng.standard_normal((16, 33)),
    "one": lambda rng: np.array([-3.25]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_int8_bit_equal_to_reference(case):
    x = CASES[case](np.random.default_rng(0)).astype(np.float32)
    rq, rs = r_coll.quantize_int8(jnp.asarray(x))
    q, s = t_coll.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert bits(s.numpy()) == bits(rs)


def test_ties_round_half_to_even_as_the_reference():
    # amax 127 gives a scale of exactly 1, so x / scale lands on the .5s
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                  -126.5, 64.5, -127.0], np.float32)
    rq, rs = r_coll.quantize_int8(jnp.asarray(x))
    q, s = t_coll.quantize_int8(torch.from_numpy(x))
    assert float(s) == 1.0 == float(rs)
    want = np.array([127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 64, -127])
    np.testing.assert_array_equal(q.numpy(), want)
    np.testing.assert_array_equal(np.asarray(rq), want)


def test_error_feedback_is_unbiased_over_time():
    """Σ of dequantized outputs + final residual == Σ of raw inputs
    (the telescoping property of error feedback), over 50 rounds."""
    rng = np.random.default_rng(1)
    err = torch.zeros(64)
    total_in, total_out = np.zeros(64), np.zeros(64)
    for t in range(50):
        x = torch.from_numpy((rng.standard_normal(64) * (0.1 + t * 0.01))
                             .astype(np.float32))
        (out,), (err,) = t_coll.compressed_psum([x], [err])
        total_in += x.numpy()
        total_out += out.numpy()
    np.testing.assert_allclose(total_out + err.numpy(), total_in,
                               rtol=1e-4, atol=1e-4)


def test_one_shard_bit_equal_to_reference_under_shard_map():
    """Eager ``shard_map``: under ``jax.jit`` XLA fuses the residual
    x − q·scale into a fused multiply-subtract, whose last bits differ
    from the two roundings both packages write."""
    rng = np.random.default_rng(2)
    mesh = jax.make_mesh((1,), ("pod",))
    f = shard_map(
        lambda a, b: r_coll.compressed_psum(a, "pod", b), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()))
    rerr = jnp.zeros((300,), jnp.float32)
    err = torch.zeros(300)
    for t in range(4):  # an eager shard_map call takes ~1.5 s here
        x = (rng.standard_normal(300) * 10.0 ** rng.integers(-3, 3)) \
            .astype(np.float32)
        rout, rerr = f(jnp.asarray(x), rerr)
        (out,), (err,) = t_coll.compressed_psum([torch.from_numpy(x)],
                                                [err])
        np.testing.assert_array_equal(bits(out.numpy()), bits(rout))
        np.testing.assert_array_equal(bits(err.numpy()), bits(rerr))


def test_four_shards_against_a_float64_mean():
    rng = np.random.default_rng(3)
    xs = [(rng.standard_normal(2048) * s).astype(np.float32)
          for s in (0.5, 1.0, 2.0, 0.01)]
    means, errs = t_coll.compressed_psum([torch.from_numpy(x) for x in xs])
    for m in means[1:]:
        assert torch.equal(m, means[0])
    scales = np.array([float(t_coll.quantize_int8(torch.from_numpy(x))[1])
                       for x in xs], np.float64)
    s_bar = scales.mean()
    bound = np.sum(scales / 2 + 127 * np.abs(s_bar - scales)) / 4
    want = np.mean(np.stack(xs).astype(np.float64), axis=0)
    got = means[0].numpy().astype(np.float64)
    assert np.max(np.abs(got - want)) <= bound * (1 + 1e-5)
    for x, e in zip(xs, errs):  # each residual is x − q·scale, exactly
        q, s = t_coll.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(
            e.numpy(), torch.from_numpy(x) - q.to(torch.float32) * s)
        assert np.abs(e.numpy()).max() <= float(s) / 2 * (1 + 1e-6)


def test_tree_compressed_psum_is_leafwise():
    rng = np.random.default_rng(4)
    trees = [{"a": torch.from_numpy(rng.standard_normal(8)
                                    .astype(np.float32)),
              "b": [torch.from_numpy(rng.standard_normal((2, 3))
                                     .astype(np.float32))]}
             for _ in range(3)]
    means, errs = t_coll.tree_compressed_psum(trees)
    ma, ea = t_coll.compressed_psum([t["a"] for t in trees])
    mb, eb = t_coll.compressed_psum([t["b"][0] for t in trees])
    for s in range(3):
        assert torch.equal(means[s]["a"], ma[s])
        assert torch.equal(means[s]["b"][0], mb[s])
        assert torch.equal(errs[s]["a"], ea[s])
        assert torch.equal(errs[s]["b"][0], eb[s])
    again, _ = t_coll.tree_compressed_psum(trees, errs)
    assert torch.equal(
        again[0]["a"], t_coll.compressed_psum(
            [t["a"] for t in trees], [e["a"] for e in errs])[0][0])


def test_int8_payload_is_a_quarter_of_float32():
    x = torch.zeros(1024)
    q, _ = t_coll.quantize_int8(x)
    assert q.dtype == torch.int8
    assert q.numel() * q.element_size() * 4 == x.numel() * x.element_size()
