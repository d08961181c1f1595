"""repro_torch's one-stream threshold scan and ``filter_then_merge`` vs
the JAX package's: ``topk_filter``'s plain version against the Pallas
kernel (interpret mode) at the reference's own cases, in float32 and
bfloat16, at the port's fixed tile width; and ``filter_then_merge`` over
several batches, state and write mask compared after each.

Tolerance: exact. Masks and counts are integers, tile maxima are input
elements or NEG_BIG; reservoir scores are compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as j_topk
from repro.kernels.topk_filter import ops as j_tf
from repro_torch.core import topk as t_topk
from repro_torch.kernels.topk_filter import ops as t_tf
from test_torch_cuda import tf_case, tied_scores


@pytest.mark.parametrize("n", [128, 4096, 5000, 100_000, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("thr", [0.5, float("-inf")])
def test_topk_filter_plain_equals_pallas(n, dtype, thr):
    """The reference's cases (n ∈ {128, 4096, 5000, 100000}) plus a row
    under one tile; NaN scores; thr = -inf counts the pad columns."""
    s = tf_case(n, n)
    js = jnp.asarray(s, dtype)
    ts = torch.tensor(s).to(getattr(torch, dtype))
    jm = j_tf.topk_filter(js, jnp.float32(thr), use_pallas=True)
    tm = t_tf.topk_filter(ts, torch.tensor(thr))
    assert tm[1].shape == (-(-n // t_tf.tile_width(n)),)
    for a, b in zip(jm, tm):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_topk_filter_all_below_threshold_and_device_dispatch():
    before = t_tf.launches
    mask, counts, tmax = t_tf.topk_filter(torch.full((512,), -5.0),
                                          torch.tensor(0.0))
    assert int(mask.sum()) == 0 and int(counts.sum()) == 0
    assert tmax.tolist() == [-5.0]
    assert t_tf.launches == before  # a CPU tensor runs the plain version
    with pytest.raises(ValueError, match="no kernel"):
        t_tf.topk_filter(torch.zeros(8, device="meta"),
                         torch.zeros((), device="meta"))
    with pytest.raises(ValueError, match="floating"):
        t_tf.topk_filter(torch.zeros(8, dtype=torch.int32),
                         torch.tensor(0.0))


@pytest.mark.parametrize("k,n", [(32, 1000), (8, 3)])
def test_filter_then_merge_bit_equal(k, n):
    """Five batches through both packages from an empty reservoir:
    scores, ids, seen and the write mask equal after every batch. Ties,
    signed zeros, a NaN and a +inf (which enters with the reference's
    pad id) are in the batches; n < k exercises the short survivor cut."""
    rng = np.random.default_rng(7)
    js = j_topk.init(k)
    ts = t_topk.init(k, device="cpu")
    for step in range(5):
        s = tied_scores(rng, n)
        if step == 2:
            s[0], s[-1] = np.nan, np.inf
        i = np.arange(step * n, (step + 1) * n, dtype=np.int32)
        js, jw = j_tf.filter_then_merge(js, jnp.asarray(s), jnp.asarray(i))
        ts, tw = t_tf.filter_then_merge(ts, torch.tensor(s),
                                        torch.tensor(i))
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        np.testing.assert_array_equal(
            np.asarray(js.scores).view(np.int32),
            ts.scores.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(js.ids), ts.ids.numpy())
        assert int(js.seen) == int(ts.seen)
    if n >= k:
        assert (ts.ids.numpy() == -(2 ** 31) + 1).any()  # the +inf entry
