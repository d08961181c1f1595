"""repro_torch's logmem backend vs the JAX package's: the admission scan
(plain version against the Pallas kernel in interpret mode and its jnp
reference), ``logmem.update`` over multi-chunk traces and from injected
mid-window states, the trace harness, and the engine's mixed
exact+logmem fleets. Plus the one recorded divergence: the reference's
phase at exact powers of two (ROADMAP queue 3).

Tolerance: exact. Every state leaf and write mask is compared with array
equality, float leaves bit for bit; tile maxima are input elements.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shp as j_shp
from repro.kernels.logmem_update import ops as j_lm_ops
from repro.streams import StreamEngine as JEngine
from repro.streams import StreamSpec as JSpec
from repro.streams import logmem as j_lm
from repro_torch.kernels.logmem_update import ops as t_lm_ops
from repro_torch.streams import engine as t_eng
from repro_torch.streams import logmem as t_lm
from test_torch_cuda import (METER_FIELDS, lm_admit_case, lm_chunks,
                             mixed_fleet_specs, ingest_mixed)


@pytest.fixture
def numpy_reference_planner():
    prev = j_shp.set_planner_backend("numpy")
    yield
    j_shp.set_planner_backend(prev)


def assert_leaves_equal(js, ts):
    """Every leaf of a reference LogmemState against the port's, float
    leaves compared by their bits."""
    for name, a, b in zip(t_lm.LogmemState._fields, js, ts):
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n", [40, 512, 600, 1024, 1500])
def test_logmem_admit_plain_equals_pallas_and_jnp(n):
    scores, ids, tau = lm_admit_case(6, n, n)
    tm = t_lm_ops.logmem_admit(torch.tensor(scores), torch.tensor(ids),
                               torch.tensor(tau))
    for use_pallas in (True, False):
        jm = j_lm_ops.logmem_admit(jnp.asarray(scores), jnp.asarray(ids),
                                   jnp.asarray(tau), use_pallas=use_pallas)
        for a, b in zip(jm, tm):
            assert np.asarray(a).dtype == b.numpy().dtype
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_logmem_admit_gates_on_ids_and_runs_plain_on_cpu():
    """Pads stay inert under tau = -inf even with a finite pad score, and
    a CPU tensor never launches the kernel."""
    before = t_lm_ops.launches
    mask, acounts, lcounts, tmax = t_lm_ops.logmem_admit(
        torch.tensor([[5.0, 1.0, 7.0, 2.0]]),
        torch.tensor([[0, -1, 1, -1]], dtype=torch.int32),
        torch.tensor([float("-inf")]))
    assert mask.tolist() == [[1, 0, 1, 0]]
    assert (acounts.item(), lcounts.item(), tmax.item()) == (2, 2, 7.0)
    assert t_lm_ops.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        t_lm_ops.logmem_admit(torch.zeros(1, 4, device="meta"),
                              torch.zeros(1, 4, dtype=torch.int32,
                                          device="meta"),
                              torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="int32"):
        t_lm_ops.logmem_admit(torch.zeros(1, 4),
                              torch.zeros(1, 4, dtype=torch.int64),
                              torch.zeros(1))


def run_both(k, chunks, js=None, ts=None):
    """Feed the same chunks to both packages' ``update``; compare every
    leaf and every write mask after each chunk."""
    m = chunks[0][0].shape[0]
    js = j_lm.init(m) if js is None else js
    ts = t_lm.init(m, device="cpu") if ts is None else ts
    for s, i in chunks:
        js, jw = j_lm.update(js, jnp.asarray(s), jnp.asarray(i), k,
                             use_pallas=False)
        ts, tw = t_lm.update(ts, torch.tensor(s), torch.tensor(i), k)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        assert_leaves_equal(js, ts)
    return js, ts


@pytest.mark.parametrize("k", [4, 64, 256])
def test_update_bit_equal_over_multichunk_traces(k):
    """From a fresh state through admit-all, the crossing chunk (cold
    top-B), steady state and several phase commits, with chunk widths
    from 1 to 4K, ties and signed zeros, pad columns and all-pad rows."""
    widths = [max(1, k // 3), k, 2 * k + 3, 1, 7, 4 * k, k // 2 + 1, 3,
              4 * k, 4 * k, 2 * k, 4 * k, 5, 4 * k]
    js, ts = run_both(k, lm_chunks(9, widths, seed=k))
    phase = ts.phase.numpy()
    assert (phase >= 2).any() and (ts.tau_floor.isfinite()).any()
    assert (ts.admits.numpy() > 0).all()


def injected_state(rng, m, k):
    """Reference-shaped mid-window leaves: cold rows far past K (so a
    narrow chunk cannot resolve the quantile), warm rows with finite
    thresholds and accumulators, phases one short of their next
    boundary."""
    seen = rng.integers(k + 1, 400 * k, m).astype(np.int32)
    cold = rng.random(m) < 0.4
    q_den = rng.uniform(0.5, 40.0, m).astype(np.float32)
    q_num = (q_den * rng.standard_normal(m)).astype(np.float32)
    floor = rng.standard_normal(m).astype(np.float32) - 1.0
    tau = np.maximum(floor, q_num / q_den).astype(np.float32)
    phase = np.floor(np.log2(seen / k)).astype(np.int32) - \
        rng.integers(0, 2, m).astype(np.int32)
    floor[cold], tau[cold] = -np.inf, -np.inf
    q_num[cold], q_den[cold] = 0.0, 0.0
    phase[cold] = -1
    ph_tau = np.full((m, t_lm.N_PHASES), -np.inf, np.float32)
    ph_adm = rng.integers(0, 50, (m, t_lm.N_PHASES)).astype(np.int32)
    admits = ph_adm.sum(1).astype(np.int32)
    return [seen, admits, tau, floor, q_num, q_den, phase, ph_tau, ph_adm]


@pytest.mark.parametrize("k", [4, 64, 256])
def test_update_bit_equal_from_injected_states(k):
    """Cold rows past the crossing with chunks too narrow to resolve the
    K/t quantile (law-budget fallback, tau stays -inf), and warm rows
    committing phases; carried across with ``state_from_numpy``."""
    rng = np.random.default_rng(100 + k)
    leaves = injected_state(rng, 10, k)
    js = j_lm.LogmemState(*(jnp.asarray(x) for x in leaves))
    ts = t_lm.state_from_numpy(leaves, device="cpu")
    assert_leaves_equal(js, ts)
    run_both(k, lm_chunks(10, [1, 2, 1, 3, 64, 1, 5 * k], seed=k + 1),
             js, ts)


def test_phase_at_power_of_two_follows_the_documented_rule():
    """The recorded divergence (ROADMAP queue 3): at t/K = 2^13 the
    reference's f32 ``jnp.log2`` on XLA's CPU backend floors to 12 and
    misses the phase boundary; the port computes ⌊log₂(t/K)⌋ = 13, so it
    commits the finished phase's estimate 3/4 into the floor and its
    phase ledger, restarts the accumulator and books the chunk's admits
    to phase 13. The chunk is too narrow to resolve the quantile, so the
    write mask, seen, admits and tau agree."""
    leaves = [np.array([32760], np.int32), np.array([0], np.int32),
              np.array([0.5], np.float32), np.array([0.1], np.float32),
              np.array([3.0], np.float32), np.array([4.0], np.float32),
              np.array([12], np.int32),
              np.full((1, t_lm.N_PHASES), -np.inf, np.float32),
              np.zeros((1, t_lm.N_PHASES), np.int32)]
    s = np.linspace(-1, 2, 8, dtype=np.float32)[None]
    i = np.arange(8, dtype=np.int32)[None]
    ts = t_lm.state_from_numpy(leaves, device="cpu")
    tn, tw = t_lm.update(ts, torch.tensor(s), torch.tensor(i), 4)
    ledger_12, ledger_13 = np.zeros(t_lm.N_PHASES, np.int32), \
        np.zeros(t_lm.N_PHASES, np.int32)
    ledger_12[12] = ledger_13[13] = 4
    committed = np.full(t_lm.N_PHASES, -np.inf, np.float32)
    committed[12] = 0.75
    want_port = {"phase": 13, "tau_floor": 0.75, "q_num": 0.0,
                 "q_den": 0.0, "phase_tau": committed,
                 "phase_admits": ledger_13}
    want_ref = {"phase": 12, "tau_floor": np.float32(0.1), "q_num": 3.0,
                "q_den": 4.0,
                "phase_tau": np.full(t_lm.N_PHASES, -np.inf, np.float32),
                "phase_admits": ledger_12}
    for use_pallas in (True, False):
        js = j_lm.LogmemState(*(jnp.asarray(x) for x in leaves))
        jn, jw = j_lm.update(js, jnp.asarray(s), jnp.asarray(i), 4,
                             use_pallas=use_pallas)
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        np.testing.assert_array_equal(np.asarray(jw)[0], s[0] > 0.5)
        for name, a, b in zip(t_lm.LogmemState._fields, jn, tn):
            a, b = np.asarray(a)[0], b.numpy()[0]
            if name in want_ref:
                np.testing.assert_array_equal(a, want_ref[name], name)
                np.testing.assert_array_equal(b, want_port[name], name)
            else:  # seen, admits, tau
                np.testing.assert_array_equal(a, b, name)
    assert (int(tn.seen[0]), int(tn.admits[0]), tn.tau[0].item()) == \
        (32768, 4, 0.75)


def test_state_helpers_equal_reference():
    js = j_lm.init(5)
    ts = t_lm.init(5, device="cpu")
    assert_leaves_equal(js, ts)
    for a, b in zip(t_lm.state_to_numpy(ts), js):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t_lm.state_bytes_per_stream(ts) == \
        j_lm.state_bytes_per_stream(js) == 220.0
    for k in (4, 256, 65536):
        assert t_lm.exact_bytes_per_stream(k) == j_lm.exact_bytes_per_stream(k)
        assert t_lm.law_slack(k) == j_lm.law_slack(k)
    n = np.array([0, 1, 7, 1000, 131072])
    np.testing.assert_array_equal(t_lm.expected_admits(n, 65536),
                                  j_lm.expected_admits(n, 65536))
    with pytest.raises(ValueError, match="9 leaves"):
        t_lm.state_from_numpy([np.zeros(1)], device="cpu")


@pytest.mark.parametrize("k,chunk", [(256, 128), (1024, 512)])
def test_trace_competitive_ratio_equals_reference(k, chunk):
    rng = np.random.default_rng(k)
    traces = rng.standard_normal((3, 16 * k)).astype(np.float32)
    traces = traces[:, :16 * k - 37]  # a partial last chunk: pads
    j = j_lm.trace_competitive_ratio(traces, k, chunk)
    t = t_lm.trace_competitive_ratio(traces, k, chunk, device="cpu")
    assert j.keys() == t.keys()
    for key in j:
        np.testing.assert_array_equal(np.asarray(j[key]),
                                      np.asarray(t[key]), err_msg=key)
    slack = t_lm.law_slack(k)
    assert t["min_ratio"] >= 1.0 - slack
    assert t["max_c"] <= t_lm.LAW_SLACK_C
    assert np.abs(t["admit_ratio"] - 1.0).max() <= 3.0 * slack


def test_mixed_engine_fleet_equals_reference():
    """Exact and logmem tenants in one fleet, routed mixed ingest: the
    port's survivors, thresholds and every meter counter equal the
    reference engine's; the exact streams equal an exact-only replay;
    logmem rows keep their contract (empty survivors, no deletes,
    occupancy = writes) and are absent from finalize_tiers."""
    specs_j, traces = mixed_fleet_specs(JSpec)
    specs_t, _ = mixed_fleet_specs(t_eng.StreamSpec)
    je = JEngine(specs_j)
    te = t_eng.StreamEngine(specs_t, device="cpu")
    alone = t_eng.StreamEngine([s for s in specs_t if s.engine == "exact"],
                               device="cpu")
    exact_sids = {s.stream_id for s in specs_t if s.engine == "exact"}
    ingest_mixed(je, specs_j, traces, np.random.default_rng(5))
    ingest_mixed(te, specs_t, traces, np.random.default_rng(5))
    ingest_mixed(alone, specs_t, traces, np.random.default_rng(5),
                 only_sids=exact_sids)
    assert [(b.k, b.engine) for b in te.buckets] == \
        [(b.k, b.engine) for b in je.buckets]
    for bi, b in enumerate(te.buckets):
        if b.engine == "logmem":
            assert_leaves_equal(je.states()[bi], te.states()[bi])
    sj, st, sa = je.finalize(), te.finalize(), alone.finalize()
    assert sj.keys() == st.keys()
    for sid in sj:
        np.testing.assert_array_equal(sj[sid], st[sid])
    for sid in exact_sids:
        np.testing.assert_array_equal(st[sid], sa[sid])
    assert je.thresholds() == te.thresholds()
    for f in METER_FIELDS + ("logmem",):
        np.testing.assert_array_equal(getattr(je.meter, f),
                                      getattr(te.meter, f), err_msg=f)
    for s in specs_t:
        row = te.stream_row(s.stream_id)
        if s.engine == "logmem":
            assert st[s.stream_id].size == 0
            assert te.meter.deletes[row].sum() == 0
            assert te.meter.writes[row].sum() == \
                te.meter.occupancy[row].sum()
            assert np.isfinite(te.thresholds()[s.stream_id])
        assert te.meter.observed[row] == traces.shape[1]
    assert set(te.finalize_tiers()) == exact_sids
    jt = je.finalize_tiers()
    for sid, out in te.finalize_tiers().items():
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(jt[sid][key], out[key])


def test_mixed_ingest_chunks_equals_reference(numpy_reference_planner):
    """Dense double-bucket ingest (an exact and a logmem bucket of
    different widths, NaN/Inf quarantined) through ``ingest_chunks``;
    planner-derived boundaries for logmem tenants stay static."""
    from repro.core import costs as j_costs
    from repro_torch.core import costs as t_costs

    def specs(spec_cls, costs_mod):
        out = [spec_cls(stream_id=i, k=4, r=40.0, migrate=i % 2 == 1)
               for i in range(6)]
        # plans that migrate at a boundary inside the window
        out += [spec_cls(stream_id=50 + i, k=32, engine="logmem",
                         cost_model=costs_mod.hbm_host_preset(
                             n_docs=512, k=32, doc_gb=8e-5,
                             window_seconds=550.0, hbm_bw_gbps=819.0,
                             host_link_gbps=42.0,
                             hbm_capacity_premium=366.0 + 10.0 * i))
                for i in range(3)]
        return out

    def chunks():
        rng = np.random.default_rng(8)
        for c in range(6):
            s0 = rng.standard_normal((6, 8)).astype(np.float32)
            s1 = rng.standard_normal((3, 64)).astype(np.float32)
            if c == 2:
                s0[1, 2], s1[0, 5], s1[2, 9] = np.nan, np.inf, -np.inf
            yield [(s0, np.tile(np.arange(8 * c, 8 * c + 8, dtype=np.int32),
                                (6, 1))),
                   (s1, np.tile(np.arange(64 * c, 64 * c + 64,
                                          dtype=np.int32), (3, 1)))]

    je = JEngine(specs(JSpec, j_costs))
    te = t_eng.StreamEngine(specs(t_eng.StreamSpec, t_costs), device="cpu")
    assert je.ingest_chunks(chunks()) == te.ingest_chunks(chunks()) == 6
    assert_leaves_equal(je.states()[1], te.states()[1])
    rows = slice(te.stream_row(50), te.m)
    assert te.plan.migrate(0) and not te.meter.migrate[rows].any()
    assert (te.meter.boundaries[rows, 0] < 512).all()
    for f in METER_FIELDS + ("logmem",):
        np.testing.assert_array_equal(getattr(je.meter, f),
                                      getattr(te.meter, f), err_msg=f)
    assert te.assign_tiers()[1] is None


def test_logmem_spec_validation():
    with pytest.raises(ValueError, match="migration cascade"):
        t_eng.StreamEngine([t_eng.StreamSpec(stream_id=0, k=8, r=4.0,
                                             engine="logmem", migrate=True)],
                           device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        t_eng.StreamEngine([t_eng.StreamSpec(stream_id=0, k=8, r=4.0,
                                             engine="approx")],
                           device="cpu")
