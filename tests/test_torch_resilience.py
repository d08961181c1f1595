"""repro_torch.resilience on the CPU against the JAX package's
repro.resilience, on the fixtures of tests/test_resilience.py: the same
seeded chunks and the same calls go through the reference's
``StreamEngine`` and the port's ``StreamEngine(device="cpu")``.

* snapshot → restore → resume, and checkpoint → kill → restore → resume
  at any chunk, are bitwise invisible on exact, mixed and logmem fleets
  and on an engine with every layer on (obs counters, residual and cost
  monitors, cost ledgers, ``replan=``);
* at-least-once delivery with exactly-once application, backoff that
  runs out, device-loss recovery, NaN/Inf quarantine;
* tier outage: evacuation, recovery with hysteresis, no budget-burn false
  fire, the context manager, tier validation, outage state in a
  checkpoint;
* two cases the reference cannot show: the port's snapshot carries the
  reference's leaves in the reference's order (so a checkpoint directory
  written by either package restores into the other), and a restore
  marks the port's quantized tier_assign bounds stale.

Every case compares the port's finals (survivors and every meter
ledger), events and summaries with the reference's after the same calls.

Tolerance: exact — integer ledgers, the same NumPy host code on
identical integers, events bit for bit — except ``drift_score_max``,
held within 1 ulp (XLA's float32 ``sqrt``, see tests/test_torch_obs.py).
"""
import json

import jax
import numpy as np
import pytest

from repro.core import costs as j_costs
from repro.core import topology as j_topo
from repro.obs import Observability as JObservability
from repro.obs import ObsConfig as JObsConfig
from repro.online import DriftConfig as JDriftConfig
from repro.online import ReplanConfig as JReplanConfig
from repro import resilience as j_res
from repro.resilience import faults as j_faults
from repro.streams import engine as j_eng
from repro_torch.checkpoint import manager as t_manager
from repro_torch.core import costs as t_costs
from repro_torch.core import topology as t_topo
from repro_torch.obs import Observability as TObservability
from repro_torch.obs import ObsConfig as TObsConfig
from repro_torch.online import DriftConfig as TDriftConfig
from repro_torch.online import ReplanConfig as TReplanConfig
from repro_torch import resilience as t_res
from repro_torch.resilience import faults as t_faults
from repro_torch.streams import engine as t_eng
from test_torch_obs import assert_snapshots_equal, events, replan_events

J = dict(name="J", eng=j_eng, res=j_res, faults=j_faults, costs=j_costs,
         topo=j_topo,
         Obs=JObservability, ObsConfig=JObsConfig, Drift=JDriftConfig,
         Replan=JReplanConfig, kw={})
T = dict(name="T", eng=t_eng, res=t_res, faults=t_faults, costs=t_costs,
         topo=t_topo,
         Obs=TObservability, ObsConfig=TObsConfig, Drift=TDriftConfig,
         Replan=TReplanConfig, kw={"device": "cpu"})
PACKAGES = (J, T)

W = 8  # docs per stream per chunk


def specs(p, backend="mixed"):
    """tests/test_resilience.py's ``_specs`` in either package: three
    3-tier exact streams plus (``mixed``) one logmem stream."""
    spec = p["eng"].StreamSpec
    out = [spec(stream_id=i, k=8, boundaries=(16.0, 64.0)) for i in range(3)]
    if backend == "mixed":
        out.append(spec(stream_id=10, k=16, r=32.0, engine="logmem"))
    elif backend == "logmem":
        out = [spec(stream_id=i, k=16, r=32.0, engine="logmem")
               for i in range(3)]
    return out


def build(p, backend="mixed", obs=False):
    return p["eng"].StreamEngine(
        specs(p, backend),
        obs=p["Obs"](p["ObsConfig"]()) if obs else None, **p["kw"])


def outage_engine(p):
    """tests/test_resilience.py's ``_outage_engine``: 3-tier exact
    streams with cost attribution on."""
    spec = p["eng"].StreamSpec
    return p["eng"].StreamEngine(
        [spec(stream_id=i, k=8, boundaries=(16.0, 64.0)) for i in range(3)],
        obs=p["Obs"](p["ObsConfig"](costs=True)), **p["kw"])


def chunk_maker(engine, seed=1000):
    """ingest_dense-shaped chunks as a pure function of the index (either
    package's engine)."""
    ms = [b.m for b in engine.buckets]

    def make_chunk(i):
        r = np.random.default_rng(seed + i)
        dense = []
        for m in ms:
            s = r.random((m, W)).astype(np.float32)
            ids = np.tile(np.arange(i * W, (i + 1) * W, dtype=np.int32),
                          (m, 1))
            dense.append((s, ids))
        return dense
    return make_chunk


def finals(eng):
    """Survivors after ``finalize`` (which meters the final read) and
    every meter ledger."""
    surv = eng.finalize()
    return ({sid: np.asarray(v) for sid, v in surv.items()},
            eng.meter.state_dict())


def assert_finals_equal(a, b):
    (sa, da), (sb, db) = a, b
    assert sa.keys() == sb.keys()
    for sid in sa:
        np.testing.assert_array_equal(sa[sid], sb[sid])
    assert da.keys() == db.keys()
    for key in da:
        np.testing.assert_array_equal(da[key], db[key], err_msg=key)
        assert da[key].dtype == db[key].dtype, key


def same_leaf(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def assert_same_leaves(jtree, ttree):
    """The port's tree, flattened in its own order, equals
    ``jax.tree_util.tree_leaves`` of the reference's, leaf by leaf."""
    jl = jax.tree_util.tree_leaves(jtree)
    tl = t_manager.tree_flatten(ttree)[0]
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert same_leaf(a, b), (i, np.asarray(a).dtype, np.asarray(b).dtype,
                                 np.asarray(a).shape, np.asarray(b).shape)


def assert_same_meta(jmeta, tmeta):
    assert json.loads(json.dumps(jmeta)) == json.loads(json.dumps(tmeta))


# ---------------------------------------------------------------------------
# snapshot / checkpoint: kill-and-restore is bitwise invisible
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["exact", "mixed", "logmem"])
def test_snapshot_restore_roundtrip_bitwise(backend):
    """tests/test_resilience.py:83 in both packages: fleet_snapshot →
    fleet_restore into a fresh engine, then resume; the port's finals
    equal its uninterrupted run's and the reference's."""
    out = {}
    for p in PACKAGES:
        ref, eng = build(p, backend), build(p, backend)
        make_chunk = chunk_maker(ref)
        for i in range(10):
            ref.ingest_dense(make_chunk(i))
        for i in range(6):
            eng.ingest_dense(make_chunk(i))
        tree, meta = p["res"].fleet_snapshot(eng)
        eng2 = build(p, backend)
        p["res"].fleet_restore(eng2, tree, meta)
        assert eng2.chunks_ingested == 6
        for i in range(6, 10):
            eng2.ingest_dense(make_chunk(i))
        out[p["name"]] = finals(eng2)
        assert_finals_equal(finals(ref), out[p["name"]])
    assert_finals_equal(out["J"], out["T"])


@pytest.mark.parametrize("kill_at", [1, 4, 9])
def test_checkpoint_kill_restore_resume_bitwise(tmp_path, kill_at):
    """tests/test_resilience.py:103: dying at any chunk and restoring the
    latest committed checkpoint resumes to the uninterrupted finals; the
    port's generations, cursors and finals equal the reference's."""
    out = {}
    for p in PACKAGES:
        d = str(tmp_path / p["name"])
        ref = build(p)
        make_chunk = chunk_maker(ref)
        for i in range(10):
            ref.ingest_dense(make_chunk(i))
        eng = build(p)
        ck = p["res"].FleetCheckpointer(d, every=2, blocking=True)
        eng.attach_checkpointer(ck)
        for i in range(kill_at):
            eng.ingest_dense(make_chunk(i))
        del eng  # the crash
        eng2 = build(p)
        ck2 = p["res"].FleetCheckpointer(d, every=2)
        gen = 0
        if kill_at < 2:  # no checkpoint committed yet — cold start
            with pytest.raises(FileNotFoundError):
                ck2.restore(eng2)
            cursor = 0
        else:
            gen = ck2.restore(eng2)
            assert gen >= 1
            cursor = eng2.chunks_ingested
            assert cursor == (kill_at // 2) * 2
        for i in range(cursor, 10):
            eng2.ingest_dense(make_chunk(i))
        out[p["name"]] = (gen, cursor, finals(eng2))
        assert_finals_equal(finals(ref), out[p["name"]][2])
    assert out["J"][:2] == out["T"][:2]
    assert_finals_equal(out["J"][2], out["T"][2])


def full_fleet(p):
    """tests/test_resilience.py:134's fleet: metrics, residual monitor,
    cost ledgers and drift/replan state on, drifted traces."""
    rng = np.random.default_rng(7)
    m, n, k, batch = 4, 1024, 16, 64
    cm = p["costs"].hbm_host_preset(n_docs=n, k=k, doc_gb=1e-4,
                                    window_seconds=60.0)
    traces = rng.standard_normal((m, n)).astype(np.float32)
    traces[:, n // 4:] += 6.0  # drift so the replanner actually fires

    def build_full(obs=None):
        obs = obs if obs is not None else p["Obs"](p["ObsConfig"](costs=True))
        return p["eng"].StreamEngine(
            [p["eng"].StreamSpec(stream_id=i, k=k, cost_model=cm)
             for i in range(m)],
            obs=obs, replan=p["Replan"](drift=p["Drift"](alpha=0.05)),
            **p["kw"])

    def chunk(i):
        sids = np.repeat(np.arange(m), batch)
        dids = np.tile(np.arange(i * batch, (i + 1) * batch), m)
        return sids, traces[:, i * batch:(i + 1) * batch].reshape(-1), dids

    return build_full, chunk, n // batch


def test_checkpoint_full_obs_replan_roundtrip(tmp_path):
    """tests/test_resilience.py:134: the engine with everything on,
    restored mid-run and resumed — replan events, cost attribution, the
    obs snapshot and the tracer's events land as in the uninterrupted
    run, and as in the reference."""
    out = {}
    for p in PACKAGES:
        build_full, chunk, n_chunks = full_fleet(p)
        ref = build_full()
        for i in range(n_chunks):
            ref.ingest(*chunk(i))
        assert len(ref.replan_events) > 0
        obs = p["Obs"](p["ObsConfig"](costs=True))
        eng = build_full(obs)
        ck = p["res"].FleetCheckpointer(str(tmp_path / p["name"]), every=3,
                                        blocking=True)
        eng.attach_checkpointer(ck)
        for i in range(10):
            eng.ingest(*chunk(i))
        obs2 = p["Obs"](p["ObsConfig"](costs=True))
        eng2 = build_full(obs2)
        p["res"].FleetCheckpointer(str(tmp_path / p["name"])).restore(eng2)
        assert eng2.chunks_ingested == 9
        for i in range(9, n_chunks):
            eng2.ingest(*chunk(i))
        fin = finals(eng2)
        assert_finals_equal(finals(ref), fin)
        assert replan_events(ref) == replan_events(eng2)
        sa, sb = ref.cost_summary(), eng2.cost_summary()
        for key in ("total", "planned", "regret"):
            np.testing.assert_array_equal(sa[key], sb[key])
        oa, ob = ref.obs_snapshot(), eng2.obs_snapshot()
        assert oa["engine"] == ob["engine"]
        assert oa["meter"] == ob["meter"]
        out[p["name"]] = dict(fin=fin, ev=replan_events(eng2),
                              summ=eng2.cost_summary(), snap=ob,
                              events=(events(obs), events(obs2)))
    j, t = out["J"], out["T"]
    assert_finals_equal(j["fin"], t["fin"])
    assert j["ev"] == t["ev"]
    for key in ("total", "planned", "regret"):
        np.testing.assert_array_equal(j["summ"][key], t["summ"][key])
    assert_snapshots_equal(j["snap"], t["snap"])
    assert j["events"] == t["events"]


def test_restore_rejects_mismatched_fleet():
    eng = build(T, "exact")
    eng.ingest_dense(chunk_maker(eng)(0))
    tree, meta = t_res.fleet_snapshot(eng)
    other = build(T, "mixed")  # different fleet shape
    with pytest.raises(ValueError, match="does not match"):
        t_res.fleet_restore(other, tree, meta)
    # without the fingerprint the bucket count still refuses
    with pytest.raises(ValueError, match="buckets"):
        t_res.fleet_restore(other, tree, {})


def test_obs_snapshot_reports_resilience(tmp_path):
    out = {}
    for p in PACKAGES:
        eng = build(p)
        ck = p["res"].FleetCheckpointer(str(tmp_path / p["name"]), every=1,
                                        blocking=True)
        eng.attach_checkpointer(ck)
        eng.ingest_dense(chunk_maker(eng)(0))
        res = eng.obs_snapshot()["resilience"]
        assert res["chunks_ingested"] == 1
        assert res["checkpoint"]["checkpoints_written"] == 1
        assert res["checkpoint"]["latest_step"] == 1
        assert res["failed_tiers"] == []
        out[p["name"]] = res
    assert out["J"] == out["T"]


def test_attach_checkpointer_needs_a_hook():
    with pytest.raises(TypeError, match="on_chunk"):
        build(T).attach_checkpointer(object())


# ---------------------------------------------------------------------------
# fault injection: at-least-once delivery, exactly-once application
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_source_equals_reference(seed):
    """The port's copy of ``faults.FaultyChunkSource`` draws the
    reference's schedule, leading failures and NaN lacing."""
    eng = build(T)
    make_chunk = chunk_maker(eng)
    kw = dict(seed=seed, transient_rate=0.4, duplicate_rate=0.5,
              reorder_rate=0.5, nan_rate=0.75, nan_docs=2)
    js = j_faults.FaultyChunkSource(make_chunk, 12, **kw)
    ts = t_faults.FaultyChunkSource(make_chunk, 12, **kw)
    assert js.schedule() == ts.schedule()
    for seq in range(12):
        assert js._failures(seq) == ts._failures(seq)
        for (a, ai), (b, bi) in zip(js.fetch(seq, 99), ts.fetch(seq, 99)):
            assert same_leaf(a, b) and same_leaf(ai, bi)
    assert (js.duplicates_injected, js.nan_injected) == \
        (ts.duplicates_injected, ts.nan_injected)


def test_faulty_delivery_exactly_once():
    """tests/test_resilience.py:217: transients + duplicates +
    reordering; each chunk applies exactly once; stats and finals equal
    the reference's."""
    out = {}
    for p in PACKAGES:
        ref = build(p)
        make_chunk = chunk_maker(ref)
        for i in range(12):
            ref.ingest_dense(make_chunk(i))
        eng = build(p)
        src = p["faults"].FaultyChunkSource(
            make_chunk, 12, seed=3, transient_rate=0.4, duplicate_rate=0.5,
            reorder_rate=0.5)
        stats = p["faults"].ingest_with_faults(eng, src, sleep_scale=0.0)
        assert stats["chunks_applied"] == 12
        assert src.failures_injected > 0 and stats["delivery_retries"] > 0
        assert src.duplicates_injected > 0
        assert stats["redeliveries_dropped"] >= src.duplicates_injected
        fin = finals(eng)
        assert_finals_equal(finals(ref), fin)
        out[p["name"]] = (stats, src.failures_injected,
                          src.duplicates_injected, fin)
    assert out["J"][:3] == out["T"][:3]
    assert_finals_equal(out["J"][3], out["T"][3])


def test_fetch_with_retry_backoff_exhausts():
    make = lambda i: []  # noqa: E731 — never reached
    for p in PACKAGES:
        src = p["faults"].FaultyChunkSource(make, 4, seed=5,
                                            transient_rate=1.0,
                                            max_transient=3)
        stats = {}
        # enough attempts: the capped failure count always clears
        p["faults"].fetch_with_retry(src, 0, max_attempts=4,
                                     sleep_scale=0.0, stats=stats)
        assert stats["delivery_retries"] == src.failures_injected == 3
        src2 = p["faults"].FaultyChunkSource(make, 4, seed=5,
                                             transient_rate=1.0,
                                             max_transient=3)
        with pytest.raises(p["faults"].TransientDeliveryError):
            p["faults"].fetch_with_retry(src2, 0, max_attempts=2,
                                         sleep_scale=0.0)


def test_device_loss_recovery_bitwise(tmp_path):
    """tests/test_resilience.py:250: simulated device loss mid-stream;
    rebuild, restore the last checkpoint, replay — the finals and the
    harness's stats equal the reference's."""
    out = {}
    for p in PACKAGES:
        ref = build(p)
        make_chunk = chunk_maker(ref)
        for i in range(10):
            ref.ingest_dense(make_chunk(i))
        ck = p["res"].FleetCheckpointer(str(tmp_path / p["name"]), every=2,
                                        blocking=True)
        src = p["faults"].FaultyChunkSource(
            make_chunk, 10, seed=3, transient_rate=0.3, duplicate_rate=0.3,
            reorder_rate=0.3, device_loss_at=7)
        eng, stats = p["faults"].run_with_recovery(lambda: build(p), src, ck,
                                                   sleep_scale=0.0)
        assert stats["restarts"] == 1
        assert stats["chunks_applied"] >= 10  # pre-crash progress + replay
        fin = finals(eng)
        assert_finals_equal(finals(ref), fin)
        out[p["name"]] = (stats, ck.manager.generation(), fin)
    assert out["J"][:2] == out["T"][:2]
    assert_finals_equal(out["J"][2], out["T"][2])


def test_device_loss_without_checkpoint_raises():
    for p in PACKAGES:
        eng = build(p)
        src = p["faults"].FaultyChunkSource(chunk_maker(eng), 6, seed=0,
                                            device_loss_at=2,
                                            max_transient=0)
        with pytest.raises(p["faults"].DeviceLossError):
            p["faults"].ingest_with_faults(eng, src, sleep_scale=0.0)
        assert eng.chunks_ingested == 2


def test_recovery_gives_up_after_max_restarts(tmp_path):
    """``run_with_recovery`` re-raises once its restarts run out."""
    class Relapsing(t_faults.FaultyChunkSource):
        def fetch(self, seq, attempt=0):
            if seq == 5:
                raise t_faults.DeviceLossError("again")
            return super().fetch(seq, attempt)

    eng = build(T)
    src = Relapsing(chunk_maker(eng), 8, seed=1)
    ck = t_res.FleetCheckpointer(str(tmp_path), every=2, blocking=True)
    with pytest.raises(t_faults.DeviceLossError):
        t_faults.run_with_recovery(lambda: build(T), src, ck,
                                   max_restarts=2, sleep_scale=0.0)


# ---------------------------------------------------------------------------
# NaN/Inf quarantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["exact", "logmem"])
def test_nan_scores_quarantined(backend):
    """tests/test_resilience.py:283: a NaN/Inf-laced delivery is bitwise
    a delivery where those slots were never sent, except the quarantine
    counter; the port's counters and finals equal the reference's."""
    out = {}
    for p in PACKAGES:
        ref = build(p, backend, obs=True)
        eng = build(p, backend, obs=True)
        make_chunk = chunk_maker(ref)
        n_bad = 0
        for i in range(6):
            clean = make_chunk(i)
            laced, blanked = [], []
            r = np.random.default_rng(9000 + i)
            for s, ids in clean:
                s_l, ids_b = s.copy(), ids.copy()
                s_b = s.copy()
                if i % 2 == 0:  # lace every other chunk
                    row = int(r.integers(0, s.shape[0]))
                    col = int(r.integers(0, s.shape[1]))
                    s_l[row, col] = np.nan if i % 4 == 0 else np.inf
                    s_b[row, col] = -np.inf
                    ids_b[row, col] = -1
                    n_bad += 1
                laced.append((s_l, ids))
                blanked.append((s_b, ids_b))
            ref.ingest_dense(blanked)
            eng.ingest_dense(laced)
        assert n_bad > 0
        snap = eng.obs_snapshot()["engine"]
        assert snap["scores_quarantined"] == n_bad
        assert ref.obs_snapshot()["engine"]["scores_quarantined"] == 0
        fin = finals(eng)
        assert_finals_equal(finals(ref), fin)
        out[p["name"]] = (eng.obs_snapshot(), fin)
    assert_snapshots_equal(out["J"][0], out["T"][0])
    assert_finals_equal(out["J"][1], out["T"][1])


def test_all_finite_input_not_perturbed():
    """tests/test_resilience.py:331: the quarantine path is inert on
    clean data."""
    out = {}
    for p in PACKAGES:
        plain, obs_eng = build(p, obs=False), build(p, obs=True)
        make_chunk = chunk_maker(plain)
        for i in range(5):
            plain.ingest_dense(make_chunk(i))
            obs_eng.ingest_dense(make_chunk(i))
        assert obs_eng.obs_snapshot()["engine"]["scores_quarantined"] == 0
        fin = finals(obs_eng)
        assert_finals_equal(finals(plain), fin)
        out[p["name"]] = fin
    assert_finals_equal(out["J"], out["T"])


def test_faulty_source_laces_and_engine_survives():
    """tests/test_resilience.py:344: seeded NaN lacing through the fault
    source; the engine quarantines every laced score."""
    out = {}
    for p in PACKAGES:
        eng = build(p, obs=True)
        src = p["faults"].FaultyChunkSource(chunk_maker(eng), 8, seed=11,
                                            nan_rate=0.75, nan_docs=2)
        p["faults"].ingest_with_faults(eng, src, sleep_scale=0.0)
        assert src.nan_injected > 0
        assert (eng.obs_snapshot()["engine"]["scores_quarantined"]
                == src.nan_injected)
        fin = finals(eng)
        out[p["name"]] = (src.nan_injected, fin)
    assert out["J"][0] == out["T"][0]
    assert_finals_equal(out["J"][1], out["T"][1])


# ---------------------------------------------------------------------------
# tier outage: masked feasible set, evacuation, hysteresis, burn grace
# ---------------------------------------------------------------------------

def test_tier_outage_evacuates_and_recovers():
    out = {}
    for p in PACKAGES:
        eng = outage_engine(p)
        make_chunk = chunk_maker(eng)
        for i in range(4):
            eng.ingest_dense(make_chunk(i))
        assert eng.meter.occupancy[:, 1].sum() > 0  # tier 1 is populated
        summary = eng.tier_outage(1)
        assert summary["rows_evacuated"] > 0
        assert eng.meter.occupancy[:, 1].sum() == 0  # evacuated
        assert eng._excluded_tier_set() == frozenset({1})
        again = eng.tier_outage(1)  # double declaration is idempotent
        assert again.get("already_failed")
        for i in range(4, 7):  # nothing lands on the failed tier
            eng.ingest_dense(make_chunk(i))
        assert eng.meter.occupancy[:, 1].sum() == 0
        eng.tier_recover(1, hysteresis=2)
        assert eng._excluded_tier_set() == frozenset({1})  # flap damping
        for i in range(7, 10):
            eng.ingest_dense(make_chunk(i))
        assert eng._excluded_tier_set() == frozenset()
        res = eng.obs_snapshot()["resilience"]
        assert res["tier_outages"] == 1 and res["failed_tiers"] == []
        out[p["name"]] = (summary, again, res, events(eng._obs), finals(eng))
    assert out["J"][:4] == out["T"][:4]
    assert_finals_equal(out["J"][4], out["T"][4])


def test_tier_outage_no_burn_false_fire():
    """The evacuation bill is planned spend: the burn-rate alert does not
    fire on it, and the bill is credited to planned spend (the port's
    monitor arrays, bill and regret equal the reference's)."""
    out = {}
    for p in PACKAGES:
        eng = outage_engine(p)
        make_chunk = chunk_maker(eng)
        for i in range(4):
            eng.ingest_dense(make_chunk(i))
        summary = eng.tier_outage(1, burn_grace=8)
        mon = eng._cost_monitor
        evac = np.zeros(eng.m, bool)
        evac[summary["rows"]] = True
        assert (mon.burn_suppressed_until[evac] > mon.steps).all()
        assert summary["bill"] >= 0.0
        for i in range(4, 10):
            eng.ingest_dense(make_chunk(i))
        assert not mon.burn_alerted[evac].any()
        summ = eng.cost_summary()
        assert np.isfinite(summ["regret"]).all()
        out[p["name"]] = (summary, mon.state_dict(), summ)
    assert out["J"][0] == out["T"][0]
    for key, val in out["J"][1].items():
        np.testing.assert_array_equal(val, out["T"][1][key], err_msg=key)
    for key in ("total", "planned", "regret"):
        np.testing.assert_array_equal(out["J"][2][key], out["T"][2][key])


def test_tier_outage_context_manager():
    out = {}
    for p in PACKAGES:
        eng = outage_engine(p)
        make_chunk = chunk_maker(eng)
        for i in range(3):
            eng.ingest_dense(make_chunk(i))
        with p["res"].TierOutage(eng, tier=1, hysteresis=1) as drill:
            assert drill.summary["rows_evacuated"] > 0
            assert 1 in eng._failed_tiers
        assert 1 not in eng._failed_tiers  # recovered on exit
        assert eng._recovering_tiers == {1: 4}
        # recovery applies even when the body raises
        eng2 = outage_engine(p)
        for i in range(3):
            eng2.ingest_dense(chunk_maker(eng2)(i))
        with pytest.raises(RuntimeError, match="drill"):
            with p["res"].TierOutage(eng2, tier=1):
                raise RuntimeError("drill gone wrong")
        assert 1 not in eng2._failed_tiers
        out[p["name"]] = (drill.summary, events(eng._obs),
                          events(eng2._obs))
    assert out["J"] == out["T"]


def test_tier_outage_validates_tier():
    for p in PACKAGES:
        eng = outage_engine(p)
        eng.ingest_dense(chunk_maker(eng)(0))
        with pytest.raises(ValueError, match="out of range"):
            eng.tier_outage(99)
        with pytest.raises(ValueError, match="not failed"):
            eng.tier_recover(1)


def test_outage_state_survives_checkpoint(tmp_path):
    """An outage declared before the crash is still masking the tier
    after restore, through a checkpoint on disk; so is a recovered tier
    inside its hysteresis window."""
    out = {}
    for p in PACKAGES:
        eng = outage_engine(p)
        make_chunk = chunk_maker(eng)
        for i in range(4):
            eng.ingest_dense(make_chunk(i))
        eng.tier_outage(1)
        ck = p["res"].FleetCheckpointer(str(tmp_path / p["name"]), every=0,
                                        keep_latest=1)
        ck.save(eng, blocking=True)
        eng2 = outage_engine(p)
        ck.restore(eng2)
        assert eng2._excluded_tier_set() == frozenset({1})
        assert eng2._tier_outages == 1
        for i in range(4, 6):
            eng2.ingest_dense(make_chunk(i))
        assert eng2.meter.occupancy[:, 1].sum() == 0
        eng2.tier_recover(1, hysteresis=3)
        ck.save(eng2, blocking=True)
        eng3 = outage_engine(p)
        ck.restore(eng3)
        assert eng3._failed_tiers == {}
        assert eng3._recovering_tiers == {1: 9}
        assert eng3._excluded_tier_set() == frozenset({1})
        out[p["name"]] = (eng3._recovering_tiers, finals(eng2),
                          finals(eng3))
    assert out["J"][0] == out["T"][0]
    assert_finals_equal(out["J"][1], out["T"][1])
    assert_finals_equal(out["J"][2], out["T"][2])


# ---------------------------------------------------------------------------
# what the reference cannot show: cross-package leaves, the tier cache
# ---------------------------------------------------------------------------

def drill_fleet(p, tenants=64, chunks=18, k=8):
    """examples/chaos_recovery.py's fleet: three-tier tenants, half
    planned and half pinned to (32, 0.8 N), re-planning and cost
    attribution on; chunk ``i`` heats the first half of the rows from
    chunk 4 on, and some pinned tenants' re-plans apply."""
    n = chunks * 32
    specs = []
    for t in range(tenants):
        cm = p["topo"].hbm_dram_disk_preset(n_docs=n, k=k, doc_gb=1e-4,
                                       window_seconds=30.0 * (1 + t % 3))
        bounds = dict(boundaries=(32.0, n * 0.8)) if t % 2 else {}
        specs.append(p["eng"].StreamSpec(stream_id=t, k=k, cost_model=cm,
                                         **bounds))
    eng = p["eng"].StreamEngine(
        specs, obs=p["Obs"](p["ObsConfig"](costs=True)),
        replan=p["Replan"](drift=p["Drift"](alpha=0.05)), **p["kw"])

    def make_chunk(i):
        r = np.random.default_rng(i)
        dense = []
        for b in eng.buckets:
            s = r.random((b.m, 32)).astype(np.float32)
            if i >= 4:
                s[: b.m // 2] += 0.5
            ids = np.tile(np.arange(i * 32, (i + 1) * 32, dtype=np.int32),
                          (b.m, 1))
            dense.append((s, ids))
        return dense
    return eng, make_chunk


def fleet_at(p, kind):
    """An engine of ``kind`` after a few chunks (and, for "outage", a
    failed tier); the full fleet has re-planned by its 9th chunk, the
    drill fleet ("replan") has applied re-plans by its 12th."""
    if kind == "replan":
        eng, make_chunk = drill_fleet(p)
        for i in range(12):
            eng.ingest_dense(make_chunk(i))
        assert any(e.applied for e in eng.replan_events)
        return eng
    if kind == "full":
        build_full, chunk, _ = full_fleet(p)
        eng = build_full()
        for i in range(9):
            eng.ingest(*chunk(i))
        assert eng.replan_events
        return eng
    if kind == "outage":
        eng = outage_engine(p)
    else:
        eng = build(p, kind, obs=kind == "mixed")
    make_chunk = chunk_maker(eng)
    for i in range(5):
        eng.ingest_dense(make_chunk(i))
    if kind == "outage":
        eng.tier_outage(1)
    return eng


@pytest.mark.parametrize("kind", ["exact", "mixed", "logmem", "full",
                                  "replan", "outage"])
def test_snapshot_leaves_equal_reference(kind):
    """The port's ``fleet_snapshot`` tree, flattened in the reference's
    order, equals ``jax.tree_util.tree_leaves`` of the reference's (dtype,
    shape and bits, leaf by leaf), and the meta is equal."""
    (jtree, jmeta), (ttree, tmeta) = [p["res"].fleet_snapshot(fleet_at(p,
                                                                        kind))
                                      for p in PACKAGES]
    assert_same_leaves(jtree, ttree)
    assert_same_meta(jmeta, tmeta)


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)])
def test_checkpoint_restores_across_packages(tmp_path, writer, reader):
    """A checkpoint directory written by one package's
    ``FleetCheckpointer`` restores into the other's engine, which then
    resumes bit-equal to the reader's uninterrupted run."""
    build_full, chunk, n_chunks = full_fleet(writer)
    eng = build_full()
    ck = writer["res"].FleetCheckpointer(str(tmp_path), every=4,
                                         blocking=True)
    eng.attach_checkpointer(ck)
    for i in range(10):
        eng.ingest(*chunk(i))
    assert eng.replan_events
    build_r, chunk_r, _ = full_fleet(reader)
    ref = build_r()
    for i in range(n_chunks):
        ref.ingest(*chunk_r(i))
    eng2 = build_r()
    gen = reader["res"].FleetCheckpointer(str(tmp_path)).restore(eng2)
    assert gen == 2 and eng2.chunks_ingested == 8
    for i in range(8, n_chunks):
        eng2.ingest(*chunk_r(i))
    assert_finals_equal(finals(ref), finals(eng2))
    assert replan_events(ref) == replan_events(eng2)
    sa, sb = ref.cost_summary(), eng2.cost_summary()
    for key in ("total", "planned", "regret"):
        np.testing.assert_array_equal(sa[key], sb[key])


def tiers_of(fin_tiers):
    return {sid: (np.asarray(v["ids"]), np.asarray(v["tiers"]),
                  np.asarray(v["counts"])) for sid, v in fin_tiers.items()}


@pytest.mark.parametrize("kind", ["replan", "outage"])
def test_restore_marks_tier_cache_stale(tmp_path, kind):
    """A re-plan or an outage changes boundaries, a checkpoint keeps
    them, a restore into a freshly built engine (whose quantized
    tier_assign bounds come from its plan) must re-quantize them:
    ``finalize_tiers`` then equals the reference's tiers, which differ
    from the plan's."""
    out = {}
    for p in PACKAGES:
        eng = fleet_at(p, kind)
        ck = p["res"].FleetCheckpointer(str(tmp_path / p["name"]), every=0)
        ck.save(eng, blocking=True)
        def fresh_engine():
            return (drill_fleet(p)[0] if kind == "replan"
                    else outage_engine(p))

        fresh = fresh_engine()
        planned = fresh.meter.boundaries.copy()
        ck.restore(fresh)
        assert not np.array_equal(planned, fresh.meter.boundaries)
        kw = {"use_pallas": False} if p is J else {}
        out[p["name"]] = tiers_of(fresh.finalize_tiers(**kw))
        if p is T:
            # a restore that left the plan's quantized bounds in place
            # would give other tiers: the case can fail
            blind = fresh_engine()
            ck.restore(blind)
            blind._bounds_stale = set()
            wrong = tiers_of(blind.finalize_tiers())
            assert any(not np.array_equal(wrong[s][1], out["T"][s][1])
                       for s in wrong)
    assert out["J"].keys() == out["T"].keys()
    for sid in out["J"]:
        for a, b in zip(out["J"][sid], out["T"][sid]):
            np.testing.assert_array_equal(a, b)
