"""repro_torch.core.topk (the torch reservoir) vs the JAX package's
core.topk: update, merge, evicted, member, threshold and tier_of on
batches with score ties, signed zeros, NaN, re-observed resident ids and
(-inf, -1) pads — the cases of tests/test_topk_reservoir.py.

Tolerance: exact. Reservoir scores are compared bit for bit (so -0.0 and
+0.0 differ), ids and write masks with array equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as j_topk
from repro_torch.core import topk as t_topk


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def assert_state_equal(js, ts):
    np.testing.assert_array_equal(bits(js.scores), bits(ts.scores.numpy()))
    np.testing.assert_array_equal(np.asarray(js.ids), ts.ids.numpy())
    np.testing.assert_array_equal(np.asarray(js.seen), ts.seen.numpy())


def t_state(js):
    return t_topk.ReservoirState(
        torch.tensor(np.asarray(js.scores)), torch.tensor(np.asarray(js.ids)),
        torch.tensor(np.asarray(js.seen)))


def nasty_scores(rng, n):
    """Scores drawn from a small set so ties are common, with signed
    zeros and infinities."""
    pool = np.array([-1.5, -0.0, 0.0, 0.0, 0.25, 0.25, 1.0, 2.0, -np.inf,
                     np.inf], np.float32)
    return pool[rng.integers(0, pool.size, n)]


def batch(rng, lo, w, state_ids, resident_frac=0.3, pad_frac=0.2):
    """W scored docs: fresh ids lo.., some replaced by resident ids
    (re-observations), some by (-inf, -1) pads."""
    ids = np.arange(lo, lo + w, dtype=np.int32)
    live = state_ids[state_ids >= 0]
    for j in range(w):
        u = rng.uniform()
        if u < resident_frac and live.size:
            ids[j] = rng.choice(live)
        elif u < resident_frac + pad_frac:
            ids[j] = -1
    _, first = np.unique(ids, return_index=True)  # ids unique within batch
    dup = np.ones(w, bool)
    dup[first] = False
    ids[dup] = -1
    scores = nasty_scores(rng, w)
    scores[ids < 0] = -np.inf
    return scores, ids


@pytest.mark.parametrize("k,w", [(1, 1), (4, 3), (8, 32), (16, 5)])
def test_update_bit_equal_single_stream(k, w):
    rng = np.random.default_rng(k * 100 + w)
    js = j_topk.init(k)
    ts = t_topk.init(k, device="cpu")
    for step in range(12):
        s, i = batch(rng, 1000 * step, w, np.asarray(js.ids))
        js, jw = j_topk.update(js, jnp.asarray(s), jnp.asarray(i))
        ts, tw = t_topk.update(ts, torch.tensor(s), torch.tensor(i))
        assert_state_equal(js, ts)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


def test_update_batched_rows_equal_vmapped_reference():
    rng = np.random.default_rng(5)
    m, k, w = 6, 8, 12
    js = jax.vmap(lambda _: j_topk.init(k))(jnp.arange(m))
    ts = t_topk.ReservoirState(*(torch.tensor(np.asarray(x)) for x in js))
    upd = jax.vmap(j_topk.update)
    for step in range(8):
        rows = [batch(rng, 100 * step, w, np.asarray(js.ids[r]))
                for r in range(m)]
        s = np.stack([r[0] for r in rows])
        i = np.stack([r[1] for r in rows])
        js, jw = upd(js, jnp.asarray(s), jnp.asarray(i))
        ts, tw = t_topk.update(ts, torch.tensor(s), torch.tensor(i))
        assert_state_equal(js, ts)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


def test_nan_scores_order_like_reference():
    """NaN sorts last in the reference's lexsort; the packed key agrees."""
    s = np.array([1.0, np.nan, -np.nan, 2.0, -np.inf, -0.0, 0.0], np.float32)
    i = np.array([5, 4, 3, 2, 1, 0, 6], np.int32)
    js, jw = j_topk.update(j_topk.init(7), jnp.asarray(s), jnp.asarray(i))
    ts, tw = t_topk.update(t_topk.init(7, device="cpu"), torch.tensor(s),
                           torch.tensor(i))
    np.testing.assert_array_equal(np.asarray(js.ids), ts.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


def test_signed_zero_ties_fall_to_the_id():
    s = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    i = np.array([7, 3, 9, 1], np.int32)
    ts, _ = t_topk.update(t_topk.init(2, device="cpu"), torch.tensor(s),
                          torch.tensor(i))
    assert ts.ids.tolist() == [1, 3]
    js, _ = j_topk.update(j_topk.init(2), jnp.asarray(s), jnp.asarray(i))
    assert_state_equal(js, ts)


def test_resident_collision_reports_no_write():
    ts = t_topk.init(3, device="cpu")
    ts, w = t_topk.update(ts, torch.tensor([5.0, 4.0, 3.0]),
                          torch.tensor([0, 1, 2], dtype=torch.int32))
    assert w.tolist() == [True, True, True]
    ts2, w2 = t_topk.update(ts, torch.tensor([1.0, 10.0]),
                            torch.tensor([1, 7], dtype=torch.int32))
    assert w2.tolist() == [False, True]
    assert sorted(ts2.ids.tolist()) == [0, 1, 7]


def _random_pair(rng, k, lo, hi):
    s = rng.standard_normal(hi - lo).astype(np.float32)
    s[rng.random(s.size) < 0.3] = 0.5  # ties across the two states
    i = np.arange(lo, hi, dtype=np.int32)
    js, _ = j_topk.update(j_topk.init(k), jnp.asarray(s), jnp.asarray(i))
    return js, t_state(js)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_evicted_member_threshold_bit_equal(seed):
    rng = np.random.default_rng(seed)
    k = 8
    ja, ta = _random_pair(rng, k, 0, 5)  # unfull: -inf, -1 pads
    jb, tb = _random_pair(rng, k, 40, 70)
    assert_state_equal(j_topk.merge(ja, jb), t_topk.merge(ta, tb))
    assert_state_equal(j_topk.merge(jb, ja), t_topk.merge(tb, ta))
    jm, tm = j_topk.merge(ja, jb), t_topk.merge(ta, tb)
    np.testing.assert_array_equal(np.asarray(j_topk.evicted(jb, jm)),
                                  t_topk.evicted(tb, tm).numpy())
    needles = rng.integers(-1, 80, 30).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(j_topk.member(jnp.asarray(needles), jm.ids)),
        t_topk.member(torch.tensor(needles), tm.ids).numpy())
    assert bits(j_topk.threshold(jm)) == bits(t_topk.threshold(tm).numpy())
    for r in (3, 45.5, np.float64(60.0)):
        np.testing.assert_array_equal(np.asarray(j_topk.tier_of(jm.ids, r)),
                                      t_topk.tier_of(tm.ids, r).numpy())
