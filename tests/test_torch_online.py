"""repro_torch.online on the CPU against the JAX package's repro.online,
on the fixtures of tests/test_online.py:

* the drift detector (``online.drift``): chunk law, the null-FPR fleet,
  the injected-burst fleet, ``reset_where`` and the detector past its
  Bonferroni budget — every state leaf and ``fired`` after every chunk,
  and ``rho_hat`` / ``anchor_seen`` / ``scores``;
* ``Replanner(backend="numpy")``, ``relocation_bill`` and ``suffix_cost``
  on the re-planner fixtures;
* ``AdmissionController`` on the admission fixtures;
* ``StreamEngine(replan=..., device="cpu")`` against the reference's
  engine on the drifted acceptance fleet (through ``evaluate_fleet``:
  realized static / re-planned / oracle costs too), the undrifted fleet,
  the mixed-depth fleet and the admission-negotiation fleet.

Tolerance: exact. The host code is the same NumPy code, and the detector
is the reference's float32 arithmetic in its order; the reference runs
the detector inside its jitted step, where XLA fuses the decayed windows'
multiply-add, and the port computes that fused form too (see
``repro_torch.online.drift``). Replan events, admission events and
boundaries are compared bit for bit (floats with ==). One exception:
the normalized change scores (``scores``, ``drift_scores``), a
diagnostic no decision reads, divide by a threshold that takes a float32
``sqrt``, which XLA on the CPU may round one ulp off where torch rounds
correctly; they are held within 1 ulp. The same sqrt sits in the
detection threshold, so ``fired`` could only differ where a deviation
lies within one ulp of its threshold; it is held equal, chunk by chunk.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as j_cons
from repro.core import costs as j_costs
from repro.core import shp as j_shp
from repro.core import simulator as j_sim
from repro.core import topology as j_topo
from repro.online import admission as j_adm
from repro.online import drift as j_drift
from repro.online import evaluate as j_eval
from repro.online import replan as j_replan
from repro.streams import engine as j_eng
from repro_torch.core import constraints as t_cons
from repro_torch.core import costs as t_costs
from repro_torch.core import shp as t_shp
from repro_torch.core import topology as t_topo
from repro_torch.online import admission as t_adm
from repro_torch.online import drift as t_drift
from repro_torch.online import evaluate as t_eval
from repro_torch.online import replan as t_replan
from repro_torch.streams import engine as t_eng
from test_torch_host import same

J = dict(costs=j_costs, cons=j_cons, shp=j_shp, topo=j_topo, drift=j_drift,
         replan=j_replan, adm=j_adm, eval=j_eval, eng=j_eng)
T = dict(costs=t_costs, cons=t_cons, shp=t_shp, topo=t_topo, drift=t_drift,
         replan=t_replan, adm=t_adm, eval=t_eval, eng=t_eng)


def two_tier_model(p, n=12000, k=64):
    """tests/test_online.py's ``_two_tier_model`` in either package."""
    costs = p["costs"]
    wl = costs.WorkloadSpec(n_docs=n, k=k, doc_gb=1e-4, window_months=0.5)
    hot = costs.TierCosts("hot", put_per_doc=1e-6, get_per_doc=2.7e-4,
                          storage_per_gb_month=0.05)
    cold = costs.TierCosts("cold", put_per_doc=8e-5, get_per_doc=1e-6,
                           storage_per_gb_month=0.02)
    return costs.TwoTierCostModel(tier_a=hot, tier_b=cold, workload=wl)


def leaves(p, state):
    if p is J:
        return {f: np.asarray(getattr(state, f)) for f in state._fields}
    return t_drift.state_to_numpy(state)


def assert_leaves_bit_equal(a, b, skip=()):
    for f in a:
        if f in skip:
            continue
        x, y = a[f], b[f]
        assert x.dtype == y.dtype and x.shape == y.shape, f
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=f)


# ---------------------------------------------------------------------------
# the drift detector
# ---------------------------------------------------------------------------

def test_chunk_law_bit_equal():
    for args in ((np.array([100]), np.array([164]), np.array([8],
                                                             np.float32)),
                 (np.array([0.0]), np.array([12.0]), np.array([16.0])),
                 (np.arange(0, 6400, 64), np.arange(64, 6464, 64),
                  np.full(100, 64.0))):
        jm, jv = (np.asarray(x) for x in j_drift.chunk_law(*args))
        tm, tv = (x.numpy() for x in t_drift.chunk_law(*args))
        assert_leaves_bit_equal({"mean": jm, "var": jv},
                                {"mean": tm, "var": tv})


def run_detectors(traces, k, cfg_kw, w=64):
    """Both packages' ``DriftEstimator`` fed by their own batched engine
    update over (M, N) traces; yields the two estimators after every
    chunk."""
    m, n = traces.shape
    j_est = j_drift.DriftEstimator(m, k=k, cfg=j_drift.DriftConfig(**cfg_kw))
    t_est = t_drift.DriftEstimator(m, k=k, cfg=t_drift.DriftConfig(**cfg_kw),
                                   device="cpu")
    j_state = j_eng.init(m, k)
    t_state = t_eng.init(m, k, device="cpu")
    for c0 in range(0, n, w):
        sc = traces[:, c0:c0 + w].astype(np.float32)
        ids = np.tile(np.arange(c0, c0 + w, dtype=np.int32), (m, 1))
        j_state, j_wrote = j_eng.update(j_state, jnp.asarray(sc),
                                        jnp.asarray(ids))
        t_state, t_wrote = t_eng.update(t_state, torch.tensor(sc),
                                        torch.tensor(ids))
        jf = j_est.observe(np.asarray(j_wrote).sum(1),
                           np.asarray(j_state.seen))
        tf = t_est.observe(t_wrote.sum(1).numpy(), t_state.seen.numpy())
        np.testing.assert_array_equal(jf, tf)
        yield j_est, t_est


@pytest.mark.parametrize("seed", [0, 1])
def test_null_fleet_detector_bit_equal(seed):
    """tests/test_online.py's null-FPR fleet: 128 i.u.d. streams."""
    rng = np.random.default_rng(seed)
    traces = rng.standard_normal((128, 4096)).astype(np.float32)
    for j_est, t_est in run_detectors(traces, 16, dict(alpha=0.05)):
        pass
    assert_leaves_bit_equal(leaves(J, j_est.state), leaves(T, t_est.state))
    assert float(t_est.state.fired.float().mean()) <= 0.05


def test_injected_burst_detector_bit_equal():
    """tests/test_online.py's 6x mid-window burst: leaves, rho_hat and the
    excursion anchor after every chunk."""
    rng = np.random.default_rng(3)
    traces = np.stack([j_sim.drifted_rank_trace(8000, rng, [(3000, 6.0)])
                       for _ in range(16)]).astype(np.float32)
    fired_any = False
    for j_est, t_est in run_detectors(traces, 64, dict(alpha=0.05)):
        assert_leaves_bit_equal(leaves(J, j_est.state),
                                leaves(T, t_est.state))
        assert np.array_equal(j_est.rho_hat().view(np.int32),
                              t_est.rho_hat().view(np.int32))
        ja = np.asarray(j_drift.anchor_seen(j_est.state))
        ta = t_drift.anchor_seen(t_est.state).numpy()
        assert np.array_equal(ja.view(np.int32), ta.view(np.int32))
        js = np.asarray(j_drift.scores(j_est.state, j_est.cfg, slack=0.05))
        ts = t_drift.scores(t_est.state, t_est.cfg, slack=0.05).numpy()
        # scores take a float32 sqrt, which XLA on the CPU may round off
        # by one ulp where torch rounds correctly
        np.testing.assert_array_max_ulp(js, ts, maxulp=1)
        fired_any |= bool(t_est.state.fired.any())
    assert fired_any


def test_state_from_reference_resumes_bit_equal():
    """A port detector started from the reference's state (the injected
    burst fleet at mid-window, via ``state_from_numpy``) and both fed the
    same next chunks stay bit-equal."""
    rng = np.random.default_rng(3)
    traces = np.stack([j_sim.drifted_rank_trace(8000, rng, [(3000, 6.0)])
                       for _ in range(16)]).astype(np.float32)
    for j_est, _ in run_detectors(traces[:, :3520], 64, dict(alpha=0.05)):
        pass
    state = t_drift.state_from_numpy(leaves(J, j_est.state), device="cpu")
    assert_leaves_bit_equal(leaves(J, j_est.state), leaves(T, state))
    cfg = t_drift.DriftConfig(alpha=0.05)
    k = np.full(16, 64.0, np.float32)
    seen = np.asarray(j_est.state.seen)
    for c in range(4):
        wrote = rng.integers(0, 20, 16)
        seen = seen + 64
        j_est.observe(wrote, seen)
        state = t_drift.update(state, wrote, seen, k, cfg)
        assert_leaves_bit_equal(leaves(J, j_est.state), leaves(T, state))


def test_reset_where_bit_equal():
    ests = [p["drift"].DriftEstimator(3, k=8, **kw)
            for p, kw in ((J, {}), (T, {"device": "cpu"}))]
    for est in ests:
        est.observe(np.array([8, 8, 8]), np.array([64, 64, 64]))
        est.observe(np.array([8, 0, 3]), np.array([128, 128, 128]))
        est.reset(np.array([True, False, False]))
    assert_leaves_bit_equal(leaves(J, ests[0].state), leaves(T, ests[1].state))
    assert float(ests[1].state.dev[0]) == 0.0


def test_detector_past_the_bonferroni_budget():
    """max_checks=4: past the budget the threshold adds 2·log(checks/4);
    leaves and ``fired`` equal after every chunk."""
    cfg = dict(alpha=0.05, max_checks=4)
    ests = [p["drift"].DriftEstimator(1, k=32, cfg=p["drift"].DriftConfig(
        **cfg), **kw) for p, kw in ((J, {}), (T, {"device": "cpu"}))]
    seen = 0.0
    for step in range(20):
        seen += 64.0
        if step < 12:
            mean, _ = j_drift.chunk_law(np.array([seen - 64.0]),
                                        np.array([seen]), np.array([32.0]))
            wrote = np.asarray(mean)
        else:
            wrote = np.array([40.0])
        flags = [est.observe(wrote, np.array([seen])) for est in ests]
        np.testing.assert_array_equal(flags[0], flags[1])
        assert_leaves_bit_equal(leaves(J, ests[0].state),
                                leaves(T, ests[1].state))
    assert bool(ests[1].state.fired[0])


# ---------------------------------------------------------------------------
# the re-planner
# ---------------------------------------------------------------------------

def replan_cases(p):
    """The re-planner fixtures of tests/test_online.py:157-272, as
    (Replanner, replan args, replan kwargs)."""
    cm = two_tier_model(p)
    nt = cm.as_ntier()
    k = nt.workload.k
    r = p["shp"].plan_placement(cm).r
    cons, rp = p["cons"], p["replan"]
    cap_half = cons.ConstraintSet(cons.TierCapacity(0, 0.5 * k))
    return [
        (rp.Replanner([nt]), ([0], [6000.0], [1.0], [(r,)], [False]), {}),
        (rp.Replanner([nt]), ([0], [3400.0], [6.0], [(r,)], [False]), {}),
        (rp.Replanner([nt]), ([0], [3400.0], [6.0], [(2000.0,)], [True]),
         {}),
        (rp.Replanner([nt], config=rp.ReplanConfig(allow_moves=False)),
         ([0], [4000.0], [6.0], [(2000.0,)], [False]), {}),
        (rp.Replanner([nt]), ([0], [3400.0], [6.0], [(3524.0,)], [False]),
         {}),
        (rp.Replanner([nt], constraints=cap_half),
         ([0], [3400.0], [6.0], [(3524.0,)], [False]), {}),
        (rp.Replanner([nt], constraints=cons.ConstraintSet(
            cons.TierCapacity(0, 1.0), cons.TierCapacity(1, 1.0))),
         ([0], [3400.0], [6.0], [(3524.0,)], [False]), {}),
        (rp.Replanner([nt], constraints=cap_half),
         ([0], [3400.0], [6.0], [(3524.0,)], [False]),
         {"hwm": np.array([[float(k), 0.0]])}),
        (rp.Replanner([nt], constraints=cap_half),
         ([0], [3400.0], [6.0], [(3524.0,)], [False]),
         {"hwm": np.array([[0.0, 0.0]])}),
        # the fleet form: several rows, mixed cascade flags, one group
        (rp.Replanner([nt, None, nt, nt]),
         ([0, 1, 2, 3], [3400.0, 3400.0, 12000.0, 7000.0],
          [6.0, 2.0, 3.0, 0.5], [(r,), (1000.0,), (r,), (5000.0,)],
          [False, False, False, False]), {}),
    ]


@pytest.mark.parametrize("case", range(10))
def test_replanner_numpy_bit_equal(case):
    (jr, ja, jk), (tr, ta, tk) = replan_cases(J)[case], replan_cases(T)[case]
    tr.backend = "numpy"
    assert same(jr.replan(*ja, **jk), tr.replan(*ta, **tk))


def test_relocation_bill_and_suffix_cost_bit_equal():
    nt = two_tier_model(J).as_ntier()
    rng = np.random.default_rng(0)
    r = 16
    b0 = rng.uniform(0, 12000, (r, 1))
    b1 = rng.uniform(0, 12000, (r, 1))
    n0 = rng.uniform(100, 11000, r)
    k = np.full(r, 64.0)
    cw, cr, cs = (np.tile(x, (r, 1)) for x in (nt.cw, nt.cr, nt.cs))
    for a, b in zip(j_replan.relocation_bill(b0, b1, n0, k, cr, cw),
                    t_replan.relocation_bill(b0, b1, n0, k, cr, cw)):
        assert np.array_equal(a, b)
    args = (cw, cr, cs, np.full(r, 12000.0), k,
            np.full(r, nt.workload.reads_per_window), n0,
            rng.uniform(0.3, 8, r), b1)
    assert np.array_equal(j_replan.suffix_cost(*args),
                          t_replan.suffix_cost(*args))


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def slo_squeezed_model(p, k=512):
    topo = p["topo"].aws_archive_tiering()
    topo = topo.replace(tiers=(
        topo.tiers[0].__class__(topo.tiers[0].costs, capacity_docs=k // 4,
                                read_latency_s=topo.tiers[0].read_latency_s),
        topo.tiers[1]))
    wl = p["costs"].WorkloadSpec(n_docs=200_000, k=k, doc_gb=1e-3,
                                 window_months=1.0)
    return topo.cost_model(wl)


def admission_cases(p):
    cons = p["cons"]
    nt = two_tier_model(p).as_ntier()
    return [(cons.ConstraintSet(), nt),
            (cons.ConstraintSet(cons.ReadLatencySLO(60.0)),
             slo_squeezed_model(p)),
            (cons.ConstraintSet(cons.TierCapacity(0, 0.0),
                                cons.TierCapacity(1, 0.0)), nt)]


@pytest.mark.parametrize("case", range(3))
def test_admission_bit_equal(case):
    (jc, jm), (tc, tm) = admission_cases(J)[case], admission_cases(T)[case]
    jd = j_adm.AdmissionController(jc).admit(jm)
    td = t_adm.AdmissionController(tc).admit(tm)
    assert same(jd, td)
    assert (td.admitted, td.negotiated) == [(True, False), (True, True),
                                            (False, False)][case]


# ---------------------------------------------------------------------------
# the engine's closed loop
# ---------------------------------------------------------------------------

def events(engine):
    return ([dataclasses.astuple(e) for e in engine.replan_events],
            engine.admission_events)


def assert_engines_equal(je, te):
    jev, jadm = events(je)
    tev, tadm = events(te)
    assert jev == tev
    assert same(jadm, tadm)
    np.testing.assert_array_equal(je.meter.boundaries, te.meter.boundaries)
    for f in ("relocations", "reloc_reads", "reloc_writes", "occupancy",
              "occupancy_hwm", "writes", "reads"):
        np.testing.assert_array_equal(getattr(je.meter, f),
                                      getattr(te.meter, f), err_msg=f)
    js, ts = je.survivors(), te.survivors()
    assert js.keys() == ts.keys()
    for sid in js:
        np.testing.assert_array_equal(js[sid], ts[sid])
    # survivors' tiers under the re-planned boundaries
    jt, tt = je.finalize_tiers(use_pallas=False), te.finalize_tiers()
    assert jt.keys() == tt.keys()
    for sid in jt:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(jt[sid][key], tt[sid][key])
    for jds, tds in zip(je._drift_states, te._drift_states):
        assert_leaves_bit_equal(leaves(J, jds), leaves(T, tds))
    jd, td = je.drift_scores(), te.drift_scores()
    assert jd.keys() == td.keys()
    np.testing.assert_array_max_ulp(  # the float32 sqrt: see above
        np.float32([jd[s] for s in jd]), np.float32([td[s] for s in jd]),
        maxulp=1)


def test_drifted_acceptance_fleet_bit_equal():
    """tests/test_online.py:387: an 8x burst at doc 3000 over 6 streams of
    12,000 docs, K=64, hot-tier capacity 4K; realized static, re-planned
    and process-oracle costs equal, and the acceptance holds on the
    port."""
    rng = np.random.default_rng(5)
    n, k, m, drift_at = 12000, 64, 6, 3000
    traces = np.stack([j_sim.drifted_rank_trace(n, rng, [(drift_at, 8.0)])
                       for _ in range(m)])
    out = []
    for p, kw in ((J, {}), (T, {"device": "cpu"})):
        cm = two_tier_model(p, n=n, k=k)
        cset = p["cons"].ConstraintSet(p["cons"].TierCapacity(0, 4 * k))
        specs = [p["eng"].StreamSpec(stream_id=i, k=k, cost_model=cm)
                 for i in range(m)]
        out.append(p["eval"].evaluate_fleet(
            traces, specs, replan=p["replan"].ReplanConfig(
                drift=p["drift"].DriftConfig(alpha=0.05)),
            drift_at=drift_at, chunk=64, constraints=cset, oracle_grid=10,
            drift_schedule=[(drift_at, 8.0)], **kw))
    jv, tv = out
    assert_engines_equal(jv.engine, tv.engine)
    for f in ("static_cost", "replanned_cost", "oracle_cost"):
        np.testing.assert_array_equal(getattr(jv, f), getattr(tv, f))
    assert jv.schedules == tv.schedules
    assert sum(e.applied for e in tv.engine.replan_events) >= 1
    assert tv.fleet_replanned < tv.fleet_static
    assert tv.fleet_replanned <= 1.10 * tv.fleet_oracle
    jr, tr = jv.engine.check_constraints(), tv.engine.check_constraints()
    assert tr["ok"] and same(jr, tr)


def test_undrifted_fleet_keeps_plan_bit_equal():
    """tests/test_online.py:369: no drift, no events, the a-priori plan
    kept bit for bit, in both packages."""
    rng = np.random.default_rng(7)
    traces = np.stack([j_sim.random_rank_trace(2048, rng) for _ in range(4)])
    engines = []
    for p, kw in ((J, {}), (T, {"device": "cpu"})):
        cm = two_tier_model(p, n=2048, k=16)
        specs = [p["eng"].StreamSpec(stream_id=i, k=16, cost_model=cm)
                 for i in range(4)]
        before = p["eng"].StreamEngine(specs, **kw).meter.boundaries.copy()
        eng = p["eval"].run_fleet(traces, specs,
                                  replan=p["replan"].ReplanConfig(),
                                  chunk=64, **kw)
        assert eng.replan_events == []
        np.testing.assert_array_equal(eng.meter.boundaries, before)
        engines.append(eng)
    assert_engines_equal(*engines)


def test_mixed_depth_fleet_bit_equal():
    """tests/test_online.py:412: 2- and 3-tier tenants mixed, 8x burst at
    doc 1500."""
    rng = np.random.default_rng(11)
    n, k, m = 6000, 32, 6
    traces = np.stack([j_sim.drifted_rank_trace(n, rng, [(1500, 8.0)])
                       for _ in range(m)])
    engines = []
    for p, kw in ((J, {}), (T, {"device": "cpu"})):
        two = two_tier_model(p, n=n, k=k)
        three = p["topo"].hbm_dram_disk_preset(n_docs=n, k=k, doc_gb=1e-5,
                                               window_seconds=600.0)
        specs = [p["eng"].StreamSpec(stream_id=i, k=k,
                                     cost_model=two if i % 2 == 0 else three)
                 for i in range(m)]
        engines.append(p["eval"].run_fleet(
            traces, specs, replan=p["replan"].ReplanConfig(
                drift=p["drift"].DriftConfig(alpha=0.05)), chunk=64, **kw))
    assert_engines_equal(*engines)
    assert engines[1].replan_events
    fin = np.where(np.isfinite(engines[1].meter.boundaries),
                   engines[1].meter.boundaries, np.inf)
    assert np.all(np.diff(fin, axis=1) >= 0)


def test_admission_negotiation_fleet_bit_equal():
    """tests/test_online.py:292: a re-planner whose constraint set makes
    every suffix re-solve infeasible — the direct call, then a drifted
    window through both engines, whose infeasible re-solves each log an
    admission event."""
    rng = np.random.default_rng(2)
    traces = np.stack([j_sim.drifted_rank_trace(2048, rng, [(600, 8.0)])
                       for _ in range(3)])
    engines = []
    for p, kw in ((J, {}), (T, {"device": "cpu"})):
        cm = two_tier_model(p, n=2048, k=16)
        cons = p["cons"]
        cset = cons.ConstraintSet(cons.TierCapacity(0, 8.0),
                                  cons.TierCapacity(1, 8.0))
        cfg = p["replan"].ReplanConfig(
            drift=p["drift"].DriftConfig(alpha=0.05))
        eng = p["eng"].StreamEngine(
            [p["eng"].StreamSpec(stream_id=i, k=16, cost_model=cm)
             for i in range(3)], replan=cfg, **kw)
        eng._replanner = p["replan"].Replanner(
            [cm.as_ntier()] * 3, constraints=cset, config=cfg, **kw)
        eng._negotiate_admission(0, 100)
        for c0 in range(0, 2048, 64):
            eng.ingest(np.repeat(np.arange(3), 64),
                       traces[:, c0:c0 + 64].reshape(-1),
                       np.tile(np.arange(c0, c0 + 64), 3))
        engines.append(eng)
    assert_engines_equal(*engines)
    te = engines[1]
    ev = te.admission_events[0]
    assert ev.stream_id == 0 and ev.position == 100
    assert ev.decision.negotiated or not ev.decision.admitted
    assert len(te.admission_events) > 1
    assert all(not e.feasible for e in te.replan_events)



def test_logmem_tenants_replan_bit_equal():
    """Exact and logmem tenants in one re-planning fleet: the logmem
    bucket's detector tests with ``law_slack`` folded in (its tenants do
    not fire on this burst), so just after the burst both engines' logmem
    detectors are set fired and the next chunk re-plans them: boundaries
    swapped without resident ids."""
    rng = np.random.default_rng(8)
    n, k, m = 4096, 64, 4
    traces = np.stack([j_sim.drifted_rank_trace(n, rng, [(1000, 8.0)])
                       for _ in range(m)])
    engines = []
    for p, kw in ((J, {}), (T, {"device": "cpu"})):
        cm = two_tier_model(p, n=n, k=k)
        eng = p["eng"].StreamEngine(
            [p["eng"].StreamSpec(stream_id=i, k=k, cost_model=cm,
                                 engine="logmem" if i >= 2 else "exact")
             for i in range(m)],
            replan=p["replan"].ReplanConfig(
                drift=p["drift"].DriftConfig(alpha=0.05)), **kw)
        lm = [b.engine for b in eng.buckets].index("logmem")
        for c0 in range(0, n, 64):
            if c0 == 1152:
                ds = eng._drift_states[lm]
                eng._drift_states[lm] = ds._replace(
                    fired=ds.fired | True if p is T
                    else jnp.ones_like(ds.fired))
            eng.ingest(np.repeat(np.arange(m), 64),
                       traces[:, c0:c0 + 64].reshape(-1),
                       np.tile(np.arange(c0, c0 + 64), m))
        engines.append(eng)
    assert_engines_equal(*engines)
    te = engines[1]
    assert {b.engine for b in te.buckets} == {"exact", "logmem"}
    assert any(e.applied and e.stream_id >= 2 for e in te.replan_events)
