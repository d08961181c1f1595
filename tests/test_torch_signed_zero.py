"""The tile maximum of the three scan kernels' plain versions
(``batched_topk``, ``topk_filter``, ``logmem_update``) against the JAX
package's, bit for bit: through the Pallas kernel in interpret mode and
through the jnp route. A tile whose maximum is zero gives +0.0 in the
reference wherever a +0.0 is in it, -0.0 otherwise; ``torch.amax`` alone
gives whichever zero comes first.

Tolerance: exact, by bits. Float outputs are compared as int32 where
neither side is NaN, and NaN against NaN; masks and counts with array
equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.batched_topk import ops as j_btk
from repro.kernels.logmem_update import ops as j_lm
from repro.kernels.topk_filter import ops as j_tf
from repro_torch.kernels.batched_topk import ops as t_btk
from repro_torch.kernels.logmem_update import ops as t_lm
from repro_torch.kernels.topk_filter import ops as t_tf
from test_torch_cuda import (BTK_ZERO_CASES, LM_ZERO_CASES, TF_PLAN_CASES,
                             ZERO_ROWS, btk_zero_case, lm_seam_case,
                             tf_zero_case, zero_row)

ROUTES = ("pallas", "jnp")


def assert_same_bits(ref, port):
    """Each output of the reference against the port's by bits, NaN
    against NaN."""
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "f":
            nan = np.isnan(a)
            np.testing.assert_array_equal(nan, np.isnan(b))
            a, b = a[~nan].view(np.int32), b[~nan].view(np.int32)
        np.testing.assert_array_equal(a, b)


def run(kernel, route, *args):
    """(reference outputs, port outputs) of ``kernel`` on numpy ``args``."""
    use_pallas = route == "pallas"
    if kernel == "batched_topk":
        scores, bars = args
        return (j_btk.batched_topk_filter(scores, bars, use_pallas=use_pallas),
                t_btk.batched_topk_filter(torch.tensor(scores),
                                          torch.tensor(bars)))
    if kernel == "topk_filter":
        scores, thr = args
        return (j_tf.topk_filter(jnp.asarray(scores), jnp.float32(thr),
                                 use_pallas=use_pallas),
                t_tf.topk_filter(torch.tensor(scores), torch.tensor(thr)))
    scores, ids, tau = args
    return (j_lm.logmem_admit(jnp.asarray(scores), jnp.asarray(ids),
                              jnp.asarray(tau), use_pallas=use_pallas),
            t_lm.logmem_admit(torch.tensor(scores), torch.tensor(ids),
                              torch.tensor(tau)))


def row_args(kernel, row):
    if kernel == "batched_topk":
        return row[None], np.array([5.0], np.float32)
    if kernel == "topk_filter":
        return row, 5.0
    return (row[None], np.arange(row.size, dtype=np.int32)[None],
            np.array([5.0], np.float32))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ZERO_ROWS)
@pytest.mark.parametrize("kernel",
                         ["batched_topk", "topk_filter", "logmem_update"])
def test_tile_max_of_a_zero_row_has_the_reference_bits(kernel, kind, route):
    """One tile of 128 against 5.0: the tile max is +0.0 when a +0.0 is
    in the tile (in either order), -0.0 when only -0.0 is."""
    ref, port = run(kernel, route, *row_args(kernel, zero_row(kind)))
    assert_same_bits(ref, port)
    tmax = port[-1].reshape(-1)
    assert tmax.tolist() == [0.0]
    assert bool(torch.signbit(tmax)) == (kind == "negative")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("m,n", LM_ZERO_CASES)
def test_logmem_admit_zeros_seam_by_bits(m, n, route):
    """lm_seam_case's "zeros": tiles whose largest live scores are ±0,
    against thresholds of ±0."""
    ref, port = run("logmem_update", route, *lm_seam_case(m, n, "zeros",
                                                          m + n))
    assert_same_bits(ref, port)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("m,n", sorted({(m, n) for m, n, offset, _ in
                                        BTK_ZERO_CASES if not offset}))
def test_batched_topk_tied_zeros_by_bits(m, n, route):
    ref, port = run("batched_topk", route, *btk_zero_case(m, n, m + n))
    assert_same_bits(ref, port)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", sorted({n for n, offset, _ in TF_PLAN_CASES
                                      if n < 10_000}))
def test_topk_filter_tied_zeros_by_bits(n, route):
    """Tied scores with tiles of maxima -0.0 and +0.0 and a few NaNs
    (demoted to NEG_BIG) against a threshold of 0.0, at the widths the
    card's kernels split on."""
    ref, port = run("topk_filter", route, tf_zero_case(n, n), 0.0)
    assert_same_bits(ref, port)
