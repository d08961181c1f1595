"""repro_torch.obs.costs on the CPU against the JAX package's
repro.obs.costs, on the fixtures of tests/test_costs_obs.py: the same
seeded chunks go through the reference's ``StreamEngine(obs=...)`` and
the port's ``StreamEngine(obs=..., device="cpu")``.

* carrying the device ``CostState`` ledger does not perturb the step
  (bit-identity with costs off);
* the ledger's integer (stream, tier) counts equal the meter's and the
  reference's; at W=1 the priced components equal the simulator's bill
  (writes and reads bit for bit, storage within 1e-9), for exact and
  logmem tenants;
* the device ledger laws (``init_bucket``, ``set_bucket_bounds``,
  ``accumulate_exact``, ``accumulate_logmem``) equal the reference's jnp
  laws, ids on the ceiled tier edges included;
* ``CostMonitor`` (a copy) gives the reference's alerts exactly: the null
  false-positive rates, and the budget burn that drives a cost-triggered
  re-plan and bends the realized-cost curve;
* ``cost_summary``, ``cost_alerts``, ``regret_table`` and its text, the
  snapshot's costs block, the expected-cost trajectory, the tracer's
  events in order and the Prometheus text (``jit`` aside).

Tolerance: exact, except ``drift_score_max`` (1 ulp, see
tests/test_torch_obs.py). Priced costs come from identical integers
through the same float64 NumPy, so they are compared with ==.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as j_sim
from repro.obs import costs as j_costs_obs
from repro_torch.core import costs as t_cc
from repro_torch.obs import costs as t_costs_obs
from repro_torch.online import evaluate as t_eval
from test_torch_host import same
from test_torch_obs import (J, PACKAGES, T, assert_prometheus_equal,
                            assert_snapshots_equal, events, ingest_window,
                            replan_events)


def w1_fleet(p, n=512, k=8, m=3, seed=0, engines=None):
    """tests/test_costs_obs.py's ``_w1_fleet`` in either package: per-doc
    (W=1) ingest, where the engine's chunk timing equals the
    simulator's."""
    cm = p["costs"].hbm_host_preset(n_docs=n, k=k, doc_gb=1e-4,
                                    window_seconds=60.0)
    rng = np.random.default_rng(seed)
    traces = [j_sim.random_rank_trace(n, rng) for _ in range(m)]
    specs = [p["eng"].StreamSpec(stream_id=i, k=k, cost_model=cm,
                                 engine=engines[i] if engines else "exact")
             for i in range(m)]
    return cm, traces, specs


def run_w1(p, traces, specs):
    m, n = len(traces), len(traces[0])
    obs = p["Obs"](p["ObsConfig"](costs=True))
    eng = p["eng"].StreamEngine(specs, obs=obs, **p["kw"])
    for pos in range(n):
        eng.ingest(np.arange(m),
                   np.array([t[pos] for t in traces], np.float32),
                   np.full(m, pos, np.int64))
    eng.finalize()
    return eng


def run_both_w1(**kw):
    out = []
    for p in PACKAGES:
        cm, traces, specs = w1_fleet(p, **kw)
        out.append((cm, traces, run_w1(p, traces, specs)))
    return out


# ---------------------------------------------------------------------------
# bit-identity
# ---------------------------------------------------------------------------

def test_costs_off_and_on_bit_identical_output():
    """tests/test_costs_obs.py:67: survivors, reservoir state and the
    meter are bit-equal with costs on and off; the ledger equals the
    reference's."""
    rng = np.random.default_rng(11)
    n, m, k = 2048, 5, 16
    traces = rng.standard_normal((m, n)).astype(np.float32)
    runs = []
    for p, costs in ((T, False), (T, True), (J, True)):
        eng = p["eng"].StreamEngine(
            [p["eng"].StreamSpec(stream_id=i, k=k, r=600.0)
             for i in range(m)],
            obs=p["Obs"](p["ObsConfig"](costs=costs)), **p["kw"])
        ingest_window(eng, traces)
        runs.append((eng, eng.finalize()))
    (e_off, s_off), (e_on, s_on), (je, js) = runs
    for sid in s_off:
        np.testing.assert_array_equal(s_off[sid], s_on[sid])
        np.testing.assert_array_equal(s_on[sid], js[sid])
    for f in ("writes", "deletes", "observed"):
        np.testing.assert_array_equal(getattr(e_off.meter, f),
                                      getattr(e_on.meter, f))
    for b_off, b_on in zip(e_off._states, e_on._states):
        for a, b in zip(b_off, b_on):
            assert torch.equal(a, b)
    assert same(j_costs_obs.device_counts(je),
                t_costs_obs.device_counts(e_on))
    assert_snapshots_equal(je.obs_snapshot(), e_on.obs_snapshot())


# ---------------------------------------------------------------------------
# the device ledger laws
# ---------------------------------------------------------------------------

def test_device_ledger_laws_equal_reference():
    """The ledger laws on the same inputs in both packages, with doc ids
    on and either side of the ceiled tier edges, pads, and a boundary
    swap after the first step."""
    rng = np.random.default_rng(3)
    m, w, k, nt = 6, 24, 8, 3
    bounds = np.array([[99.5, 200.0], [0.0, 50.2], [10.0, np.inf],
                       [np.inf, np.inf], [100.0, 100.0], [7.9, 31.1]])
    ids = rng.integers(0, 240, (m, w)).astype(np.int32)
    ids[0, :4] = [99, 100, 199, 200]
    ids[:, -3:] = -1
    wrote = rng.random((m, w)) < 0.4
    ev = rng.integers(-1, 240, (m, k)).astype(np.int32)
    st = rng.integers(-1, 240, (m, k)).astype(np.int32)
    out = []
    for mod, arr in ((j_costs_obs, jnp.asarray),
                     (t_costs_obs, torch.from_numpy)):
        kw = {} if mod is j_costs_obs else {"device": "cpu"}
        cs = mod.init_bucket(m, bounds, nt, **kw)
        cs = mod.accumulate_exact(cs, arr(ids), arr(wrote), arr(ev), arr(st))
        cs = mod.set_bucket_bounds(cs, 1, [20.5])
        cs = mod.accumulate_exact(cs, arr(ids), arr(wrote), arr(ev), arr(st))
        lm = mod.accumulate_logmem(mod.init_bucket(m, bounds, nt, **kw),
                                   arr(ids), arr(wrote))
        lm = mod.accumulate_logmem(lm, arr(ids), arr(wrote))
        out.append([np.asarray(x) for x in (*cs, *lm)])
    for a, b in zip(*out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert out[1][1][0, 0] > 0


# ---------------------------------------------------------------------------
# ledger reconciliation: device == meter == simulator
# ---------------------------------------------------------------------------

def test_cost_ledger_reconciles_with_simulator_at_w1():
    """tests/test_costs_obs.py:98: the ledger's counts equal the meter's
    and the priced components the simulator's bill; ``cost_summary``
    equals the reference's bit for bit."""
    n, k = 512, 8
    (_, _, je), (cm, traces, eng) = run_both_w1(n=n, k=k, m=3, seed=0)
    summ = eng.cost_summary()
    assert same(je.cost_summary(), summ)
    dev = summ["device"]
    np.testing.assert_array_equal(dev["writes"], eng.meter.writes)
    np.testing.assert_array_equal(dev["deletes"], eng.meter.deletes)
    np.testing.assert_array_equal(dev["resident_steps"],
                                  eng.meter.doc_steps)
    nt = cm if isinstance(cm, t_cc.NTierCostModel) else cm.as_ntier()
    slot = nt.workload.window_months / n
    depth = int(np.isfinite(eng.meter.boundaries[0]).sum())
    for i, t in enumerate(traces):
        res = t_eval.realized(t, k, cm,
                              tuple(eng.meter.boundaries[i][:depth]))
        np.testing.assert_array_equal(res.writes_per_tier,
                                      eng.meter.writes[i])
        dm = np.rint(res.doc_months_per_tier / slot).astype(np.int64)
        np.testing.assert_array_equal(dm, dev["resident_steps"][i])
        assert res.cost_writes == summ["writes"][i]
        assert res.cost_reads == summ["reads"][i]
        assert np.isclose(res.cost_storage, summ["storage"][i], rtol=1e-9)
        assert np.isclose(res.cost_total, summ["total"][i], rtol=1e-9)


def test_logmem_ledger_reconciles_with_meter_at_w1():
    """tests/test_costs_obs.py:129: logmem rows count cumulative writes as
    occupancy: device equals meter and the reference."""
    (_, _, je), (_, _, eng) = run_both_w1(n=512, k=16, m=4, seed=2,
                                          engines=["logmem"] * 4)
    dev = t_costs_obs.device_counts(eng)
    assert same(j_costs_obs.device_counts(je), dev)
    np.testing.assert_array_equal(dev["writes"], eng.meter.writes)
    assert int(dev["deletes"].sum()) == 0
    np.testing.assert_array_equal(dev["resident_steps"],
                                  eng.meter.doc_steps)
    assert same(je.cost_summary(), eng.cost_summary())


# ---------------------------------------------------------------------------
# CostMonitor: null FPR and the overspend -> re-plan chain
# ---------------------------------------------------------------------------

def cost_null_monitor(p, seed, alpha, m=48):
    n, k = 4096, 16
    cm = p["costs"].hbm_host_preset(n_docs=n, k=k, doc_gb=1e-4,
                                    window_seconds=60.0)
    rng = np.random.default_rng(seed)
    traces = np.stack([j_sim.random_rank_trace(n, rng) for _ in range(m)])
    eng = p["eng"].StreamEngine(
        [p["eng"].StreamSpec(stream_id=i, k=k, cost_model=cm)
         for i in range(m)],
        obs=p["Obs"](p["ObsConfig"](costs=True, cost_alpha=alpha)),
        **p["kw"])
    ingest_window(eng, traces)
    return eng._cost_monitor


@pytest.mark.parametrize("seed,alpha", [(0, 0.05), (1, 0.01)])
def test_cost_monitor_null_fpr(seed, alpha):
    """tests/test_costs_obs.py:181: the copy flags the reference's
    streams exactly, at the reference's scores, and the null
    false-positive rate of either channel stays <= alpha."""
    jm, tm = (cost_null_monitor(p, seed, alpha) for p in PACKAGES)
    np.testing.assert_array_equal(jm.alerted, tm.alerted)
    np.testing.assert_array_equal(jm.burn_alerted, tm.burn_alerted)
    np.testing.assert_array_equal(jm.scores(), tm.scores())
    np.testing.assert_array_equal(jm.burn_ratio(), tm.burn_ratio())
    assert same(jm.cost_z(), tm.cost_z())
    assert float((tm.alerted | tm.burn_alerted).mean()) <= alpha


def burn_fleet(p, m=4, n=12000, k=64, drift_at=3000, chunk=64,
               engines=None, alert_at=None):
    """tests/test_costs_obs.py:199 (examples/cost_attribution.py): half
    the tenants drift into the expensive-write cold tier; the detector is
    nearly blind, the cost channel triggers the re-plans. ``alert_at``:
    the doc position before which every logmem row's cost alert is set,
    as if the channel had fired."""
    cm = p["costs"].TwoTierCostModel(
        tier_a=p["costs"].TierCosts("hot", put_per_doc=1e-6,
                                    get_per_doc=2.7e-4,
                                    storage_per_gb_month=0.05),
        tier_b=p["costs"].TierCosts("cold", put_per_doc=8e-5,
                                    get_per_doc=1e-6,
                                    storage_per_gb_month=0.02),
        workload=p["costs"].WorkloadSpec(n_docs=n, k=k, doc_gb=1e-4,
                                         window_months=0.5))
    rng = np.random.default_rng(7)
    drifted = np.array([i < m // 2 for i in range(m)])
    traces = np.stack([
        j_sim.drifted_rank_trace(n, rng, [(drift_at, 8.0)])
        if drifted[i] else j_sim.random_rank_trace(n, rng)
        for i in range(m)])
    obs = p["Obs"](p["ObsConfig"](costs=True, cost_trigger=True,
                                  cost_alpha=0.01))
    eng = p["eng"].StreamEngine(
        [p["eng"].StreamSpec(stream_id=i, k=k, cost_model=cm,
                             engine=engines[i] if engines else "exact")
         for i in range(m)], obs=obs,
        constraints=p["cons"].ConstraintSet(p["cons"].TierCapacity(0, 4 * k)),
        replan=p["Replan"](drift=p["Drift"](alpha=1e-9)), **p["kw"])
    sids = np.arange(m)
    realized = []
    for t0 in range(0, n, chunk):
        c = min(chunk, n - t0)
        if t0 == alert_at:
            eng._cost_monitor.alerted |= eng.meter.logmem
        eng.ingest(np.repeat(sids, c), traces[:, t0:t0 + c].reshape(-1),
                   np.tile(t0 + np.arange(c), m))
        realized.append(eng._cost_monitor.realized_total[drifted].sum())
    eng.finalize()
    return eng, obs, traces, drifted, np.asarray(realized)


def test_budget_burn_drives_replan_and_bends_cost_curve():
    """tests/test_costs_obs.py:199: the reference's events (cost alerts,
    budget burns, cost-triggered re-plans, spans) in order, its realized
    curve, cost alerts, summary, regret table and Prometheus text; and
    the acceptance chain on the port."""
    (je, jo, traces, _, jr), (te, to, _, drifted, realized) = (
        burn_fleet(p) for p in PACKAGES)
    assert events(jo) == events(to)
    assert replan_events(je) == replan_events(te)
    np.testing.assert_array_equal(jr, realized)
    assert je.cost_alerts() == te.cost_alerts()
    assert same(je.cost_summary(), te.cost_summary())
    assert_snapshots_equal(je.obs_snapshot(), te.obs_snapshot())
    assert_prometheus_equal(jo.prometheus(), to.prometheus())
    jt = J["eval"].regret_table(je, traces, drift_at=3000, grid=4)
    tt = t_eval.regret_table(te, traces, drift_at=3000, grid=4)
    assert same(jt, tt)
    assert J["eval"].format_regret_table(jt) == \
        t_eval.format_regret_table(tt)

    evs = to.tracer.events
    fired = [e["attrs"] for e in evs
             if e["name"] in ("cost_alert", "budget_burn")]
    assert any(drifted[a["row"]] for a in fired)
    applied = [e["attrs"] for e in evs
               if e["name"] == "replan_decision"
               and e["attrs"]["cost_triggered"] and e["attrs"]["applied"]]
    assert applied
    rc = min(min(a["position"] for a in applied) // 64, len(realized) - 3)
    dc = 3000 // 64
    pre = (realized[rc] - realized[dc]) / max(rc - dc, 1)
    post = (realized[-1] - realized[rc + 1]) / max(len(realized) - rc - 2, 1)
    assert post < pre, (pre, post)
    kinds = {v["kind"] for v in te.cost_alerts().values()}
    assert kinds <= {"residual", "burn"} and kinds
    # each replan span precedes its decisions
    names = [e["name"] for e in evs]
    first = names.index("replan_decision")
    assert "replan" in names[:first]
    worst_drifted = max(tt[i]["regret"] for i in range(4) if drifted[i])
    worst_calm = max(tt[i]["regret"] for i in range(4) if not drifted[i])
    assert worst_drifted > worst_calm


def test_cost_trigger_mixed_exact_and_logmem_fleet():
    """The burn fleet with one drifted and one calm tenant on the logmem
    backend. The cost channel's thresholds widen by the backend's
    ``law_slack`` (0.5 at K=64), so its logmem rows do not fire on this
    burst: after the burst both engines' logmem rows are set alerted,
    and the next chunk re-solves them with the cost trigger named; their
    cumulative writes already break the hot-tier cap, so the re-solves
    are infeasible and negotiate admission. Every event, summary and
    counter equals the reference's."""
    (je, jo, *_), (te, to, *_) = (
        burn_fleet(p, n=6000, engines=["logmem", "exact", "logmem", "exact"],
                   alert_at=3200) for p in PACKAGES)
    assert events(jo) == events(to)
    assert replan_events(je) == replan_events(te)
    assert je.cost_alerts() == te.cost_alerts()
    assert same(je.cost_summary(), te.cost_summary())
    assert_snapshots_equal(je.obs_snapshot(), te.obs_snapshot())
    assert {b.engine for b in te.buckets} == {"exact", "logmem"}
    logmem_rows = set(np.flatnonzero(te.meter.logmem))
    decided = [e["attrs"] for e in to.tracer.events
               if e["name"] == "replan_decision"
               and e["attrs"]["row"] in logmem_rows]
    assert decided and all(a["cost_triggered"] for a in decided)
    assert {e.row for e in te.admission_events} == logmem_rows


def test_expected_cost_trajectory_matches_simulator_mean():
    """tests/test_costs_obs.py:253: the trajectory equals the reference's
    and tracks the realized i.u.d. bill."""
    n, k = 512, 8
    (_, _, je), (_, _, eng) = run_both_w1(n=n, k=k, m=3, seed=4)
    trajs = []
    for mod, e in ((j_costs_obs, je), (t_costs_obs, eng)):
        pricing = mod.stream_pricing(e)
        depth = int(np.isfinite(e.meter.boundaries[0]).sum())
        trajs.append(mod.expected_cost_trajectory(
            e.meter.boundaries[0][:depth], n, k, pricing["cw"][0],
            pricing["step_rate"][0]))
        trajs.append(mod.expected_cost_trajectory(
            e.meter.boundaries[0][:depth], n, k, pricing["cw"][0],
            pricing["step_rate"][0], chunk=64, logmem=True))
    np.testing.assert_array_equal(trajs[0], trajs[2])
    np.testing.assert_array_equal(trajs[1], trajs[3])
    traj = trajs[2]
    assert traj.shape == (n,)
    assert np.all(np.diff(traj) >= -1e-12)
    summ = eng.cost_summary()
    assert np.isclose(traj[-1], np.mean(summ["writes"] + summ["storage"]),
                      rtol=0.15)


def test_cost_monitor_snapshot_and_export_shape():
    """tests/test_costs_obs.py:276: the costs block is scalars only and
    equals the reference's; the Prometheus text equals it too."""
    (_, _, je), (_, _, eng) = run_both_w1(n=256, k=8, m=2, seed=3)
    snap = eng.obs_snapshot()["costs"]
    for group in ("realized", "regret", "device", "alerts"):
        assert all(np.isscalar(v) or isinstance(v, (int, float))
                   for v in snap[group].values()), group
    assert snap == je.obs_snapshot()["costs"]
    text = eng._obs.prometheus()
    assert ("# TYPE repro_obs_engines_engine0_costs_device_resident_steps "
            "counter") in text
    assert "costs_realized_total" in text
    assert_prometheus_equal(je._obs.prometheus(), text)
