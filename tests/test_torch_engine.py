"""repro_torch.streams.engine (exact backend) vs the JAX package's
streams.engine: the batched update functions from a shared mid-window
state, and StreamEngine over several chunks — narrow (W < K) and wide
batches, NaN/Inf-laced chunks, two- and three-tier plans, migrating
streams — compared on survivors, write and eviction masks, every
FleetMeter counter and finalize_tiers. Plus the port's own self-check
against core.simulator replays and the double-buffered ingest (on the
card: tests/test_torch_cuda.py).

Tolerance: exact. Reservoir scores are compared bit for bit; ids, masks,
tiers and meter counters with array equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costs as j_costs
from repro.core import shp as j_shp
from repro.core import topology as j_topo
from repro.streams import engine as j_eng
from repro_torch.core import costs as t_costs
from repro_torch.core import topology as t_topo
from repro_torch.streams import engine as t_eng
from test_torch_cuda import (METER_FIELDS, dense_chunks, run_self_check,
                             uniform_engine)


@pytest.fixture
def numpy_reference_planner():
    prev = j_shp.set_planner_backend("numpy")
    yield
    j_shp.set_planner_backend(prev)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def assert_states_equal(js, ts):
    np.testing.assert_array_equal(bits(js.scores), bits(ts.scores.cpu()))
    np.testing.assert_array_equal(np.asarray(js.ids), ts.ids.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(js.seen),
                                  ts.seen.cpu().numpy())


def assert_same(a, b):
    """Recursive equality of two reports (dicts, lists, numpy arrays)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert_same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def tied_chunk(rng, m, w, lo):
    """Scores from a small pool (ties, signed zeros), ids lo..lo+w per
    row, some (-inf, -1) pads."""
    pool = np.array([-1.0, -0.0, 0.0, 0.5, 0.5, 1.0, 2.0], np.float32)
    s = np.where(rng.random((m, w)) < 0.5,
                 pool[rng.integers(0, pool.size, (m, w))],
                 rng.standard_normal((m, w))).astype(np.float32)
    i = np.tile(np.arange(lo, lo + w, dtype=np.int32), (m, 1))
    pad = rng.random((m, w)) < 0.1
    s[pad], i[pad] = -np.inf, -1
    return s, i


def mid_window_state(rng, m, k):
    js = j_eng.init(m, k)
    for c in range(3):
        s, i = tied_chunk(rng, m, k // 2 + c, 100 * c)
        js, _ = j_eng.update(js, jnp.asarray(s), jnp.asarray(i))
    return js


def test_state_numpy_roundtrip():
    rng = np.random.default_rng(0)
    js = mid_window_state(rng, 12, 8)
    ts = t_eng.state_from_numpy(*(np.asarray(x) for x in js), device="cpu")
    assert_states_equal(js, ts)
    for a, b in zip(t_eng.state_to_numpy(ts), js):
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32
                                      else a, bits(b) if a.dtype == np.float32
                                      else np.asarray(b))


@pytest.mark.parametrize("fn", ["update", "filtered_update"])
@pytest.mark.parametrize("w", [8, 40])
def test_batched_update_bit_equal(fn, w):
    rng = np.random.default_rng(w)
    m, k = 12, 8
    js = mid_window_state(rng, m, k)
    ts = t_eng.state_from_numpy(*(np.asarray(x) for x in js), device="cpu")
    for c in range(4):
        s, i = tied_chunk(rng, m, w, 1000 + 100 * c)
        # re-observe some resident ids, above and below the bar
        i[:, :2] = np.asarray(js.ids)[:, :2]
        s[:, 0] = 5.0
        kw = {"use_pallas": True} if fn == "filtered_update" else {}
        js2, jw = getattr(j_eng, fn)(js, jnp.asarray(s), jnp.asarray(i), **kw)
        ts2, tw = getattr(t_eng, fn)(ts, torch.tensor(s), torch.tensor(i))
        assert_states_equal(js2, ts2)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        np.testing.assert_array_equal(
            np.asarray(j_eng.evicted_ids(js, js2)),
            t_eng.evicted_ids(ts, ts2).numpy())
        js, ts = js2, ts2
    r = np.linspace(3.0, 5000.0, m)
    np.testing.assert_array_equal(np.asarray(j_eng.placements(js, r)),
                                  t_eng.placements(ts, r).numpy())
    rb = np.sort(np.stack([r, 2 * r], 1), 1)
    np.testing.assert_array_equal(np.asarray(j_eng.placements(js, rb)),
                                  t_eng.placements(ts, rb).numpy())


def three_tier_model(costs, topology, n, k, scale):
    tiers = tuple(
        topology.TierSpec(costs.TierCosts(name, put * scale, get, store))
        for name, put, get, store in (("hot", 1e-6, 2.7e-4, 0.05),
                                      ("warm", 2e-5, 4e-5, 0.03),
                                      ("cold", 8e-5, 1e-6, 0.004)))
    wl = costs.WorkloadSpec(n_docs=n, k=k, doc_gb=1e-3, window_months=0.5)
    return topology.TierTopology(tiers=tiers).cost_model(wl)


def fleet_specs(eng, costs, topology, n):
    """Two-tier presets, three-tier topologies, explicit migrating and
    static boundaries; K in {4, 8, 16}."""
    rng = np.random.default_rng(11)
    specs = []
    for sid in range(18):
        k = (4, 8, 16)[sid % 3]
        kind = sid % 6
        if kind in (0, 1):
            cm = costs.hbm_host_preset(
                n_docs=n, k=k, doc_gb=float(rng.uniform(1e-6, 1e-4)),
                window_seconds=float(rng.uniform(10, 600)),
                hbm_bw_gbps=819.0,
                host_link_gbps=float(rng.uniform(8, 64)),
                hbm_capacity_premium=float(rng.uniform(5, 500)))
            specs.append(eng.StreamSpec(stream_id=sid, k=k, cost_model=cm))
        elif kind in (2, 3):
            cm = three_tier_model(costs, topology, n, k,
                                  float(rng.uniform(0.2, 5)))
            specs.append(eng.StreamSpec(stream_id=sid, k=k, cost_model=cm))
        elif kind == 4:
            specs.append(eng.StreamSpec(stream_id=sid, k=k, r=n / 4.5,
                                        migrate=True))
        else:
            specs.append(eng.StreamSpec(stream_id=sid, k=k,
                                        boundaries=(n / 5, n / 2.5),
                                        migrate=bool(sid % 2)))
    return specs


def chunk_plan(n):
    """(start, width) of every chunk: wide, narrow (W < K) and wide."""
    out, t = [], 0
    for w in [16] * 3 + [2] * 8 + [32] * 4 + [5] * 4 + [32] * 4:
        out.append((t, min(w, n - t)))
        t += w
        if t >= n:
            break
    return out


def test_stream_engine_bit_equal_over_chunks(numpy_reference_planner):
    n = 300
    je = j_eng.StreamEngine(fleet_specs(j_eng, j_costs, j_topo, n))
    te = t_eng.StreamEngine(fleet_specs(t_eng, t_costs, t_topo, n),
                            device="cpu")
    assert [b.stream_ids for b in je.buckets] == \
        [b.stream_ids for b in te.buckets]
    np.testing.assert_array_equal(je.meter.boundaries, te.meter.boundaries)
    rng = np.random.default_rng(2)
    m = len(je._row_of)
    traces = rng.standard_normal((m, n)).astype(np.float32)
    traces[3, 10:14] = [np.nan, np.inf, -np.inf, np.nan]  # laced chunk
    traces[5, 40] = np.nan
    traces[:, 70:80] = np.round(traces[:, 70:80])  # ties
    for c, (t0, w) in enumerate(chunk_plan(n)):
        sids = np.repeat(np.arange(m), w)
        dids = np.tile(np.arange(t0, t0 + w), m)
        sc = traces[:, t0:t0 + w].reshape(-1)
        perm = rng.permutation(sids.size)
        dense = je.router.route(sids[perm], sc[perm], dids[perm])
        tdense = te.router.route(sids[perm], sc[perm], dids[perm])
        for (a, b), (x, y) in zip(dense, tdense):
            np.testing.assert_array_equal(a, x)
            np.testing.assert_array_equal(b, y)
        jw, jev, jst = je._dispatch(je._stage_batches(dense), donate=False)
        je._consume(dense, jw, jev, jst)
        tw, tev, tst = te._dispatch(te._to_device(dense))
        te._consume(dense, tw, tev, tst, meter=True)
        for bi in range(len(je.buckets)):
            np.testing.assert_array_equal(np.asarray(jw[bi]), tw[bi].numpy())
            np.testing.assert_array_equal(np.asarray(jev[bi]),
                                          tev[bi].numpy())
            assert_states_equal(jst[bi], tst[bi])
    assert je.thresholds() == te.thresholds()
    js, ts = je.finalize(), te.finalize()
    assert js.keys() == ts.keys()
    for sid in js:
        np.testing.assert_array_equal(js[sid], ts[sid])
    for f in METER_FIELDS:
        np.testing.assert_array_equal(getattr(je.meter, f),
                                      getattr(te.meter, f), err_msg=f)
    for row in range(m):
        assert je.meter.ledger(row).as_dict() == te.meter.ledger(row).as_dict()
    jr, tr = je.meter.reconcile(batch=16), te.meter.reconcile(batch=16)
    assert_same({k: jr[k] for k in jr}, {k: tr[k] for k in jr})
    jt, tt = je.finalize_tiers(), te.finalize_tiers()
    for sid in jt:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(np.asarray(jt[sid][key]),
                                          tt[sid][key])
    assert int(te.meter.floor.max()) > 0  # a cascade fired


def test_check_constraints_bit_equal(numpy_reference_planner):
    from repro.core import constraints as j_cons
    from repro_torch.core import constraints as t_cons
    n = 200
    engines = []
    for eng, costs, topology, cons in ((j_eng, j_costs, j_topo, j_cons),
                                       (t_eng, t_costs, t_topo, t_cons)):
        specs = fleet_specs(eng, costs, topology, n)
        kw = {} if eng is j_eng else {"device": "cpu"}
        e = eng.StreamEngine(specs, **kw)
        rng = np.random.default_rng(4)
        sc = rng.standard_normal((len(specs), n)).astype(np.float32)
        for t0 in range(0, n, 20):
            m = len(specs)
            e.ingest(np.repeat(np.arange(m), 20), sc[:, t0:t0 + 20].ravel(),
                     np.tile(np.arange(t0, t0 + 20), m))
        cset = cons.ConstraintSet(cons.TierCapacity(0, 3.0),
                                  cons.ReadLatencySLO(0.5))
        engines.append(e.check_constraints(
            cset, latencies=np.array([0.001, 0.01, 2.0])))
    assert_same(engines[0], engines[1])


def test_self_check_matches_simulator_and_meter():
    run_self_check("cpu")


def test_ingest_chunks_equals_reference_ingest_chunks():
    je = uniform_engine(j_eng)
    te = uniform_engine(t_eng, "cpu")
    assert je.ingest_chunks(dense_chunks(16, 16, 8, 1)) == \
        te.ingest_chunks(dense_chunks(16, 16, 8, 1)) == 8
    assert_states_equal(je.states()[0], te.states()[0])
    for f in METER_FIELDS:
        np.testing.assert_array_equal(getattr(je.meter, f),
                                      getattr(te.meter, f), err_msg=f)


def test_not_ported_parts_raise():
    spec = [t_eng.StreamSpec(stream_id=0, k=4, r=10.0)]
    for kw, item in (({"replan": object()}, "item 6"),
                     ({"obs": object()}, "item 7"),
                     ({"mesh": object()}, "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            t_eng.StreamEngine(spec, device="cpu", **kw)
    with pytest.raises(ValueError, match="migration cascade"):
        t_eng.StreamEngine([t_eng.StreamSpec(stream_id=0, k=4, r=10.0,
                                             engine="logmem", migrate=True)],
                           device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        t_eng.StreamEngine([t_eng.StreamSpec(stream_id=0, k=4, r=10.0,
                                             engine="fast")], device="cpu")


def test_signed_zero_tie_at_the_survivor_cut_follows_reference():
    """lax.top_k ranks +0.0 above -0.0 while the merge's lexsort treats
    them as equal, so the reference's two update paths keep different
    documents here; the port reproduces both."""
    s = np.array([[-0.0, 0.0]], np.float32)
    i = np.array([[0, 1]], np.int32)
    for fn, kept in (("update", 0), ("filtered_update", 1)):
        js, _ = getattr(j_eng, fn)(j_eng.init(1, 1), jnp.asarray(s),
                                   jnp.asarray(i))
        ts, _ = getattr(t_eng, fn)(t_eng.init(1, 1, device="cpu"),
                                   torch.tensor(s), torch.tensor(i))
        assert int(js.ids[0, 0]) == int(ts.ids[0, 0]) == kept
