"""repro_torch.obs on the CPU against the JAX package's repro.obs, on the
fixtures of tests/test_obs.py: the same seeded chunks go through the
reference's ``StreamEngine(obs=...)`` and the port's
``StreamEngine(obs=..., device="cpu")``.

* obs off vs on: survivors, reservoir state and meter bit-identical;
* the device counters (``obs.metrics``) reconcile with the meter and
  equal the reference's, NaN scores quarantined;
* ``ResidualMonitor``'s null false-positive rate (a copy: the
  reference's exact alerts), residual alerts at or before the CUSUM
  detection and the residual trigger on the drifted acceptance fleet;
* the model-referenced residuals on a mixed-depth fleet, the structured
  constraint report and its events;
* ``obs_snapshot``, ``residual_alerts``, the tracer's events in order
  (``ts`` and ``dur_s`` excluded), the tracer's JSONL, the Prometheus
  text (the ``jit`` section excluded) and ``Observability.write``;
* ``timers.time_torch``.

Tolerance: exact — integer counters, the same NumPy host code on
identical integers, events bit for bit — except ``drift_score_max``,
held within 1 ulp: it reads the detector's normalized score, whose
float32 ``sqrt`` XLA on the CPU may round one ulp off where torch rounds
correctly (see tests/test_torch_online.py).

The reference's two jit-probe tests cannot run here (its jitted planner
fails to import ``enable_x64`` on this jax, so its probes never fire),
and the port's probe counts the kernels' nvcc build, which the reference
does not have: ``jits`` is held on its own (``test_jits_*``), through a
stand-in ``nvcc`` that writes an empty library.
"""
import json
import os
import stat
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import constraints as j_cons
from repro.core import costs as j_costs
from repro.core import simulator as j_sim
from repro.obs import Observability as JObservability
from repro.obs import ObsConfig as JObsConfig
from repro.obs import export as j_export
from repro.obs import trace as j_trace
from repro.obs.residuals import ResidualMonitor as JResidualMonitor
from repro.online import DriftConfig as JDriftConfig
from repro.online import ReplanConfig as JReplanConfig
from repro.online import evaluate as j_eval
from repro.streams import engine as j_eng
from repro_torch.core import constraints as t_cons
from repro_torch.core import costs as t_costs
from repro_torch.kernels import build as t_build
from repro_torch.obs import Observability as TObservability
from repro_torch.obs import ObsConfig as TObsConfig
from repro_torch.obs import export as t_export
from repro_torch.obs import http as t_http
from repro_torch.obs import jits as t_jits
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import timers as t_timers
from repro_torch.obs import trace as t_trace
from repro_torch.obs.residuals import ResidualMonitor as TResidualMonitor
from repro_torch.online import DriftConfig as TDriftConfig
from repro_torch.online import ReplanConfig as TReplanConfig
from repro_torch.online import evaluate as t_eval
from repro_torch.streams import engine as t_eng
from test_torch_host import same

J = dict(costs=j_costs, cons=j_cons, eng=j_eng, eval=j_eval,
         Obs=JObservability, ObsConfig=JObsConfig, Drift=JDriftConfig,
         Replan=JReplanConfig, kw={})
T = dict(costs=t_costs, cons=t_cons, eng=t_eng, eval=t_eval,
         Obs=TObservability, ObsConfig=TObsConfig, Drift=TDriftConfig,
         Replan=TReplanConfig, kw={"device": "cpu"})
PACKAGES = (J, T)


# ---------------------------------------------------------------------------
# shared helpers (tests/test_torch_costs_obs.py uses them too)
# ---------------------------------------------------------------------------

def two_tier_model(p, n=12000, k=64):
    """tests/test_obs.py's ``_two_tier_model`` in either package."""
    costs = p["costs"]
    wl = costs.WorkloadSpec(n_docs=n, k=k, doc_gb=1e-4, window_months=0.5)
    hot = costs.TierCosts("hot", put_per_doc=1e-6, get_per_doc=2.7e-4,
                          storage_per_gb_month=0.05)
    cold = costs.TierCosts("cold", put_per_doc=8e-5, get_per_doc=1e-6,
                           storage_per_gb_month=0.02)
    return costs.TwoTierCostModel(tier_a=hot, tier_b=cold, workload=wl)


def ingest_window(eng, traces, chunk=64, first_doc=0):
    """tests/test_obs.py's ingest loop: every stream's next ``chunk``
    docs as one mixed batch (doc ids from ``first_doc``)."""
    m, n = traces.shape
    sids = np.arange(m)
    for t0 in range(0, n, chunk):
        c = min(chunk, n - t0)
        eng.ingest(np.repeat(sids, c), traces[:, t0:t0 + c].reshape(-1),
                   np.tile(first_doc + t0 + np.arange(c), m))


def events(obs):
    """The tracer's records in order, without their clock fields."""
    return [(e["v"], e["kind"], e["name"], e["attrs"])
            for e in obs.tracer.events]


def assert_ulp1(a, b):
    np.testing.assert_array_max_ulp(np.float32(a), np.float32(b), maxulp=1)


def assert_snapshots_equal(js, ts):
    """Two engines' ``obs_snapshot`` dicts equal, the drift score within
    1 ulp (the float32 sqrt, see the module docstring)."""
    js, ts = json.loads(json.dumps(js)), json.loads(json.dumps(ts))
    if "engine" in js:
        assert_ulp1(js["engine"].pop("drift_score_max"),
                    ts["engine"].pop("drift_score_max"))
    assert js == ts


def prometheus_samples(text):
    """{metric line name: value} of a Prometheus text, and the comment
    lines in order, without the ``jit`` section (the reference probes
    its jitted planner, the port its kernel build)."""
    samples, comments = {}, []
    for line in text.splitlines():
        if "_jit_" in line:
            continue
        if line.startswith("#"):
            comments.append(line)
        else:
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    return samples, comments


def assert_prometheus_equal(jtext, ttext):
    (js, jc), (ts, tc) = prometheus_samples(jtext), prometheus_samples(ttext)
    assert jc == tc
    assert js.keys() == ts.keys()
    for name in js:
        if name.endswith("drift_score_max"):
            assert_ulp1(js[name], ts[name])
        else:
            assert js[name] == ts[name], name


def drifted_fleet(p, m=6, n=12000, k=64, drift_at=3000, mult=8.0, seed=5):
    """tests/test_obs.py's ``_drifted_fleet`` in either package (the
    traces drawn by the reference's simulator)."""
    rng = np.random.default_rng(seed)
    traces = np.stack([j_sim.drifted_rank_trace(n, rng, [(drift_at, mult)])
                       for _ in range(m)])
    cm = two_tier_model(p, n=n, k=k)
    specs = [p["eng"].StreamSpec(stream_id=i, k=k, cost_model=cm)
             for i in range(m)]
    cset = p["cons"].ConstraintSet(p["cons"].TierCapacity(0, 4 * k))
    return traces, specs, cset


def run_fleet(p, traces, specs, cset=None, obs=None, alpha=0.05, chunk=64):
    return p["eval"].run_fleet(
        traces, specs, replan=p["Replan"](drift=p["Drift"](alpha=alpha)),
        chunk=chunk, constraints=cset, obs=obs, **p["kw"])


def replan_events(eng):
    return [(e.stream_id, e.row, e.position, e.rho, e.old_bounds,
             e.new_bounds, e.applied, e.feasible, e.suffix_cost_old,
             e.suffix_cost_new, e.move_bill, e.moved_docs)
            for e in eng.replan_events]


def assert_states_equal(je, te):
    for jb, tb in zip(je._states, te._states):
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# bit-identity + device counters
# ---------------------------------------------------------------------------

def test_obs_off_and_on_bit_identical_output():
    """tests/test_obs.py:58: survivors, reservoir state and the meter are
    bit-equal with obs on and off in the port, and equal the
    reference's; the on-run's counters equal the reference's."""
    rng = np.random.default_rng(11)
    n, m, k = 2048, 5, 16
    traces = rng.standard_normal((m, n)).astype(np.float32)
    runs = {}
    for name, p, obs_on in (("t_off", T, False), ("t_on", T, True),
                            ("j_on", J, True)):
        obs = p["Obs"](p["ObsConfig"]()) if obs_on else None
        eng = p["eng"].StreamEngine(
            [p["eng"].StreamSpec(stream_id=i, k=k, r=600.0)
             for i in range(m)], obs=obs, **p["kw"])
        ingest_window(eng, traces)
        runs[name] = (eng, eng.finalize())
    (e_off, s_off), (e_on, s_on) = runs["t_off"], runs["t_on"]
    je, js = runs["j_on"]
    assert sorted(s_off) == sorted(s_on) == sorted(js)
    for sid in s_off:
        np.testing.assert_array_equal(s_off[sid], s_on[sid])
        np.testing.assert_array_equal(s_on[sid], js[sid])
    for f in ("writes", "observed", "deletes", "reads", "doc_steps"):
        np.testing.assert_array_equal(getattr(e_off.meter, f),
                                      getattr(e_on.meter, f))
        np.testing.assert_array_equal(getattr(e_on.meter, f),
                                      getattr(je.meter, f))
    for b_off, b_on in zip(e_off._states, e_on._states):
        for a, b in zip(b_off, b_on):
            assert torch.equal(a, b)
    assert_states_equal(je, e_on)
    assert e_off._metrics_state is None
    assert_snapshots_equal(je.obs_snapshot(), e_on.obs_snapshot())


def test_device_counters_reconcile_with_meter():
    """tests/test_obs.py:94: the drained counters equal the host meter's
    ledger, and the reference's counters, exactly."""
    rng = np.random.default_rng(3)
    n, m, k = 4096, 4, 16
    traces = rng.standard_normal((m, n)).astype(np.float32)
    snaps = []
    for p in PACKAGES:
        eng = p["eng"].StreamEngine(
            [p["eng"].StreamSpec(stream_id=i, k=k, r=1200.0)
             for i in range(m)], obs=p["Obs"](p["ObsConfig"]()), **p["kw"])
        ingest_window(eng, traces)
        snaps.append(eng.obs_snapshot())
    em = snaps[1]["engine"]
    assert em["docs"] == int(eng.meter.observed.sum()) == n * m
    assert em["admits"] == int(eng.meter.writes.sum())
    assert em["evictions"] == int(eng.meter.deletes.sum())
    assert em["chunks"] == n // 64
    assert em["bar_candidates"] == em["docs"]
    assert em["bar_passes"] >= em["admits"]
    assert 0.0 < em["filter_pass_rate"] < 1.0
    assert snaps[0]["engine"] == em
    assert_snapshots_equal(*snaps)


def test_quarantine_counter_and_mixed_backends_equal_reference():
    """Exact and logmem buckets in one observed fleet with NaN and ±inf
    scores in some chunks: the quarantine slot counts them, and every
    counter, the meter and the snapshot equal the reference's."""
    rng = np.random.default_rng(21)
    n, k_exact, k_lm = 1024, 8, 64
    traces = rng.standard_normal((6, n)).astype(np.float32)
    traces[0, 70] = np.nan
    traces[4, 300:305] = np.inf
    traces[5, 900] = -np.inf
    snaps = []
    for p in PACKAGES:
        specs = [p["eng"].StreamSpec(stream_id=i, k=k_exact,
                                     boundaries=(100.0, 500.0))
                 for i in range(3)]
        specs += [p["eng"].StreamSpec(stream_id=3 + i, k=k_lm, r=400.0,
                                      engine="logmem") for i in range(3)]
        eng = p["eng"].StreamEngine(specs, obs=p["Obs"](p["ObsConfig"]()),
                                    **p["kw"])
        ingest_window(eng, traces)
        snaps.append(eng.obs_snapshot())
    assert snaps[1]["engine"]["scores_quarantined"] == 7
    assert snaps[1]["engine"]["docs"] == 6 * n - 7
    assert snaps[1]["fleet"]["logmem_streams"] == 3
    assert int(eng.meter.writes.sum()) == snaps[1]["engine"]["admits"]
    assert_snapshots_equal(*snaps)


def test_metrics_canonical_round_trip_and_one_drain():
    """``to_canonical`` / ``from_canonical`` keep every slot and the
    score's bits; the accumulate laws fold as the reference's do."""
    ms = t_metrics.init(device="cpu")
    ms = t_metrics.accumulate_quarantine(ms, torch.tensor(3, dtype=torch.int32))
    ms = t_metrics.accumulate_bucket(
        ms, torch.tensor([[0.5, -1.0], [2.0, 0.1]]),
        torch.tensor([[4, -1], [7, 8]], dtype=torch.int32),
        torch.tensor([0.0, float("-inf")]),
        torch.tensor([[True, False], [True, True]]),
        torch.tensor([[2, -1], [-1, -1]], dtype=torch.int32))
    ms = t_metrics.accumulate_drift(ms, torch.tensor(1.25),
                                    torch.tensor(2, dtype=torch.int32))
    ms = t_metrics.bump_chunk(ms)
    snap = t_metrics.snapshot(ms)
    assert snap == {"docs": 3, "admits": 3, "evictions": 1,
                    "bar_candidates": 3, "bar_passes": 3,
                    "filter_pass_rate": 1.0, "chunks": 1,
                    "drift_score_max": 1.25, "drift_fired": 2,
                    "scores_quarantined": 3}
    assert ms.counts.dtype == torch.int32 and ms.counts.shape == (8,)
    counts, score = t_metrics.to_canonical(ms)
    back = t_metrics.from_canonical(counts, score, device="cpu")
    assert torch.equal(back.counts, ms.counts)
    assert back.drift_score_max.view(torch.int32) == \
        ms.drift_score_max.view(torch.int32)


# ---------------------------------------------------------------------------
# residual alert channel
# ---------------------------------------------------------------------------

def monitor_alerts(p, seed, alpha, m=128):
    """tests/test_obs.py's ``_monitor_null_fpr`` in either package: the
    monitor fed from the engine's batched update over a null window."""
    rng = np.random.default_rng(seed)
    n, k, w = 4096, 16, 64
    traces = rng.standard_normal((m, n)).astype(np.float32)
    writes = np.zeros(m)
    if p is J:
        import jax.numpy as jnp
        mon = JResidualMonitor(np.full(m, k, np.float64), alpha=alpha)
        state = j_eng.init(m, k)
    else:
        mon = TResidualMonitor(np.full(m, k, np.float64), alpha=alpha)
        state = t_eng.init(m, k, device="cpu")
    for c0 in range(0, n, w):
        ids = np.tile(np.arange(c0, c0 + w, dtype=np.int32), (m, 1))
        if p is J:
            state, wrote = j_eng.update(state, jnp.asarray(
                traces[:, c0:c0 + w]), jnp.asarray(ids))
        else:
            state, wrote = t_eng.update(state, torch.from_numpy(
                traces[:, c0:c0 + w].copy()), torch.from_numpy(ids))
        writes += np.asarray(wrote).sum(1)
        mon.update(np.asarray(state.seen), writes)
    return mon


@pytest.mark.parametrize("seed,alpha", [(0, 0.05), (1, 0.01)])
def test_residual_monitor_null_fpr(seed, alpha):
    """tests/test_obs.py:135: the copy gives the reference's alerts and
    scores exactly, and the null false-positive rate stays <= alpha."""
    jm, tm = (monitor_alerts(p, seed, alpha) for p in PACKAGES)
    np.testing.assert_array_equal(jm.alerted, tm.alerted)
    np.testing.assert_array_equal(jm.scores(), tm.scores())
    assert same(jm.write_z(), tm.write_z())
    assert float(tm.alerted.mean()) <= alpha


def test_residual_alerts_at_or_before_cusum_on_acceptance_fleet():
    """tests/test_obs.py:151: residual alerts, replan events, snapshots
    and the event timeline equal the reference's; the residual channel
    flags >= 90% of the detected streams at or before detection."""
    out = []
    for p in PACKAGES:
        traces, specs, cset = drifted_fleet(p)
        obs = p["Obs"](p["ObsConfig"](residual_alpha=0.05))
        out.append((run_fleet(p, traces, specs, cset, obs=obs), obs))
    (je, jo), (te, to) = out
    assert replan_events(je) == replan_events(te)
    alerts = te.residual_alerts()
    assert je.residual_alerts() == alerts
    assert events(jo) == events(to)
    assert_snapshots_equal(je.obs_snapshot(), te.obs_snapshot())
    detected = {}
    for ev in te.replan_events:
        detected.setdefault(ev.stream_id, ev.position)
    assert detected
    won = sum(1 for sid, pos in detected.items()
              if alerts.get(sid) is not None and alerts[sid] <= pos)
    assert won / len(detected) >= 0.9
    names = [e["name"] for e in to.tracer.events]
    assert "residual_alert" in names and "replan_decision" in names
    assert [s["name"] for s in to.tracer.spans()][-1] == "online.run_fleet"


def test_reconcile_residuals_mixed_depth_drifted_fleet():
    """tests/test_obs.py:178: 2- and 3-tier streams, half drifted 8x: the
    monitor's write-law z, the meter's reconcile and the alerts equal
    the reference's, with the reference's acceptance."""
    rng = np.random.default_rng(7)
    n, k, m, chunk = 6400, 32, 6, 64
    drifted = np.array([False, True, False, True, False, True])
    traces = np.stack([
        j_sim.drifted_rank_trace(n, rng, [(1600, 8.0)]) if d
        else rng.standard_normal(n).astype(np.float64)
        for d in drifted])
    out = []
    for p in PACKAGES:
        specs = [p["eng"].StreamSpec(stream_id=i, k=k, r=0.29 * n)
                 if i % 2 == 0 else
                 p["eng"].StreamSpec(stream_id=i, k=k,
                                     boundaries=(0.2 * n, 0.6 * n))
                 for i in range(m)]
        obs = p["Obs"](p["ObsConfig"](residual_alpha=0.05))
        eng = p["eng"].StreamEngine(specs, obs=obs, **p["kw"])
        ingest_window(eng, traces, chunk)
        out.append((eng, obs))
    (je, jo), (te, to) = out
    rec = te.meter.reconcile(batch=chunk)
    assert same(je.meter.reconcile(batch=chunk), rec)
    z = te._residuals.write_z()["z"]
    assert same(je._residuals.write_z(), te._residuals.write_z())
    assert events(jo) == events(to)
    assert_snapshots_equal(je.obs_snapshot(), te.obs_snapshot())
    assert float(np.abs(rec["rel_err"][~drifted]).mean()) < 0.2
    assert float(np.abs(z[~drifted]).max()) < 3.5
    assert bool(np.all(rec["rel_err"][drifted] > 0.3))
    assert bool(np.all(z[drifted] > 5.0))
    alerted_rows = {te.stream_row(s) for s in te.residual_alerts()}
    assert alerted_rows == set(np.flatnonzero(drifted))


def test_residual_trigger_feeds_replanner():
    """tests/test_obs.py:219: with ``residual_trigger`` the alerted rows
    join the re-plan trigger; events (``residual_triggered`` on every
    decision) and replan events equal the reference's."""
    out = []
    for p in PACKAGES:
        traces, specs, cset = drifted_fleet(p, m=4)
        obs = p["Obs"](p["ObsConfig"](residual_alpha=0.05,
                                      residual_trigger=True))
        out.append((run_fleet(p, traces, specs, cset, obs=obs), obs))
    (je, jo), (te, to) = out
    assert replan_events(je) == replan_events(te)
    assert events(jo) == events(to)
    applied = {e.stream_id for e in te.replan_events if e.applied}
    assert applied == set(range(4))
    decisions = [e for e in to.tracer.events
                 if e["name"] == "replan_decision"]
    assert decisions and all("residual_triggered" in d["attrs"]
                             for d in decisions)
    spans = [s["name"] for s in to.tracer.spans()]
    assert spans.count("replan") >= 1 and spans[0] == "plan"


# ---------------------------------------------------------------------------
# structured constraint report
# ---------------------------------------------------------------------------

def test_check_constraints_structured_report_and_events():
    """tests/test_obs.py:240: an over-capacity hot tier gives the
    reference's structured report and ``constraint_violation`` events."""
    rng = np.random.default_rng(2)
    n, m, k = 1024, 3, 16
    traces = rng.standard_normal((m, n)).astype(np.float32)
    out = []
    for p in PACKAGES:
        obs = p["Obs"](p["ObsConfig"]())
        eng = p["eng"].StreamEngine(
            [p["eng"].StreamSpec(stream_id=i, k=k, r=float(n))
             for i in range(m)], obs=obs, **p["kw"])
        ingest_window(eng, traces)
        eng.finalize()
        report = eng.check_constraints(
            p["cons"].ConstraintSet(p["cons"].TierCapacity(0, k // 2)))
        out.append((report, obs))
    (jr, jo), (report, to) = out
    assert same(jr, report)
    assert events(jo) == events(to)
    assert not report["ok"]
    v = report["violations"][0]
    assert v["kind"] == "capacity" and v["tier"] == 0
    assert v["stream_id"] in set(range(m))
    assert v["measured"] > v["limit"]
    assert v["margin"] == pytest.approx(v["measured"] - v["limit"])
    ev = [e for e in to.tracer.events if e["name"] == "constraint_violation"]
    assert len(ev) == len(report["violations"])
    assert ev[0]["attrs"]["kind"] == "capacity"
    assert [s["name"] for s in to.tracer.spans()] == \
        ["ingest"] * (n // 64) + ["finalize"]


# ---------------------------------------------------------------------------
# jits (held on its own), tracer, export, timers
# ---------------------------------------------------------------------------

def test_jits_probe_registry_and_counters():
    """The copied registry: get-or-create, track (a callable without a
    cache counts hits), record, per-key tallies, snapshot, reset."""
    p = t_jits.probe("test.registry")
    assert t_jits.probe("test.registry") is p
    p.reset()
    assert p.track(lambda x: x + 1, 1, key="a") == 2
    p.record(True, 0.5, key="a", cache_size=3)
    p.record(False, 9.0, key="b")
    snap = t_jits.snapshot()["test.registry"]
    assert snap == {"calls": 3, "hits": 2, "misses": 1, "compile_s": 0.5,
                    "cache_size": 3,
                    "by_key": {"a": {"calls": 2, "misses": 1,
                                     "compile_s": 0.5},
                               "b": {"calls": 1, "misses": 0,
                                     "compile_s": 0.0}}}
    t_jits.reset()
    assert t_jits.snapshot()["test.registry"]["calls"] == 0


def test_jits_kernel_build_probe(tmp_path, monkeypatch):
    """The kernel build reports to ``kernels.build``: a compile is a miss
    with its seconds, a build that finds the library up to date a hit.
    A stand-in nvcc writes an empty library (no nvcc on the CPU box)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(t_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(t_build, "nvcc", lambda: str(fake))
    probe = t_jits.probe("kernels.build")
    probe.reset()
    assert set(t_build.build(["batched_topk", "tier_assign"])) == {
        "batched_topk", "tier_assign"}
    assert t_build.build(["batched_topk"]) == {}
    snap = t_jits.snapshot()["kernels.build"]
    assert (snap["calls"], snap["misses"], snap["hits"]) == (3, 2, 1)
    assert snap["compile_s"] > 0.0 and snap["cache_size"] == 2
    assert snap["by_key"]["batched_topk"]["calls"] == 2
    assert snap["by_key"]["tier_assign"]["misses"] == 1
    assert os.listdir(tmp_path / "kernels")


def test_tracer_schema_and_jsonl_roundtrip(tmp_path):
    """tests/test_obs.py:301: the same records and JSONL as the
    reference's tracer, the clock fields aside."""
    recs = []
    for mod in (j_trace, t_trace):
        tr = mod.Tracer(None)
        with tr.span("outer", m=4) as attrs:
            attrs["extra"] = np.int64(7)
            tr.emit("point", x=1.5, t=torch.tensor(2))
        path = tr.write(str(tmp_path / f"{mod.__name__}.jsonl"))
        recs.append([json.loads(line) for line in open(path)])
    for r in recs:
        for rec in r:
            rec.pop("ts")
            rec.pop("dur_s")
    assert recs[0] == recs[1]
    assert [r["name"] for r in recs[1]] == ["point", "outer"]
    assert recs[1][1]["attrs"] == {"m": 4, "extra": 7}


def test_tracer_profiler_annotations():
    """``profiler_annotations`` mirrors spans as torch.profiler ranges."""
    from torch.profiler import ProfilerActivity, profile
    tr = t_trace.Tracer(None, annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("ingest"):
            torch.ones(4).sum()
    assert "ingest" in {e.name for e in prof.events()}
    assert tr.spans("ingest")[0]["kind"] == "span"


def test_prometheus_exposition_format():
    """tests/test_obs.py:317: the same exposition text as the
    reference's."""
    snap = {"engines": {"engine0": {"engine": {"docs": 12, "rate": 0.5},
                                    "tiers": [3, 4]}},
            "skip": "strings are not exported"}
    text = t_export.to_prometheus(snap, prefix="t")
    assert text == j_export.to_prometheus(snap, prefix="t")
    lines = text.splitlines()
    assert "# TYPE t_engines_engine0_engine_docs counter" in lines
    assert "# TYPE t_engines_engine0_engine_rate gauge" in lines
    assert 't_engines_engine0_tiers{idx="0"} 3' in lines
    assert not any("skip" in ln for ln in lines)


def test_observability_snapshot_prometheus_and_write(tmp_path):
    """A drifted, re-planning observed fleet: ``Observability.snapshot``,
    the Prometheus text (``jit`` aside) and the three artifacts equal
    the reference's."""
    out = []
    for p in PACKAGES:
        traces, specs, cset = drifted_fleet(p, m=3, n=4096, drift_at=1200)
        obs = p["Obs"](p["ObsConfig"](residual_alpha=0.05, costs=True))
        run_fleet(p, traces, specs, cset, obs=obs)
        d = tmp_path / ("j" if p is J else "t")
        out.append((obs, obs.write(str(d))))
    (jo, jp), (to, tp) = out
    assert sorted(tp) == ["events", "metrics", "prometheus"]
    assert_prometheus_equal(jo.prometheus(), to.prometheus())
    js, ts = jo.snapshot(), to.snapshot()
    assert js["events"] == ts["events"]
    assert_snapshots_equal(js["engines"]["engine0"],
                           ts["engines"]["engine0"])
    assert_prometheus_equal(open(jp["prometheus"]).read(),
                            open(tp["prometheus"]).read())
    jl = [json.loads(x) for x in open(jp["events"])]
    tl = [json.loads(x) for x in open(tp["events"])]
    assert [(r["kind"], r["name"], r["attrs"]) for r in jl] == \
        [(r["kind"], r["name"], r["attrs"]) for r in tl]
    metrics = json.load(open(tp["metrics"]))
    assert metrics["engines"]["engine0"]["resilience"] == {
        "chunks_ingested": 64, "failed_tiers": [], "recovering_tiers": [],
        "tier_outages": 0}


def test_http_endpoint_serves_monotone_counters():
    """``obs.http``: /metrics is the Prometheus text with typed counters,
    monotone across scrapes of a live engine; /snapshot is JSON."""
    rng = np.random.default_rng(4)
    traces = rng.standard_normal((3, 512)).astype(np.float32)
    obs = TObservability(TObsConfig(costs=True))
    eng = t_eng.StreamEngine(
        [t_eng.StreamSpec(stream_id=i, k=8,
                          cost_model=two_tier_model(T, n=512, k=8))
         for i in range(3)], obs=obs, device="cpu")
    server = t_http.serve(obs, port=0)
    try:
        scrapes = []
        for first_doc in (0, 256):
            ingest_window(eng, traces[:, first_doc:first_doc + 256],
                          first_doc=first_doc)
            with urllib.request.urlopen(server.url + "/metrics",
                                        timeout=10) as r:
                scrapes.append(r.read().decode())
        with urllib.request.urlopen(server.url + "/snapshot",
                                    timeout=10) as r:
            snap = json.loads(r.read())
    finally:
        server.stop()
    counters = [line.split()[2] for line in scrapes[1].splitlines()
                if line.startswith("# TYPE") and line.endswith("counter")
                and "_jit_" not in line]
    assert any(c.endswith("engine_docs") for c in counters)
    values = [prometheus_samples(s)[0] for s in scrapes]
    assert all(values[1][c] >= values[0][c] for c in counters)
    docs = [v for c, v in values[1].items() if c.endswith("engine_docs")]
    assert docs == [3 * 512.0]
    assert snap["engines"]["engine0"]["engine"]["chunks"] == 8


def test_timers_disciplines():
    """tests/test_obs.py:340 with ``time_torch`` in place of
    ``time_jax``."""
    us = t_timers.time_torch(lambda x: x + 1, torch.zeros(8), reps=3)
    assert us > 0.0
    sec = t_timers.time_best(lambda: sum(range(100)), repeats=2)
    assert sec >= 0.0
    with t_timers.span("s") as sp:
        pass
    assert sp.dur_s >= 0.0
