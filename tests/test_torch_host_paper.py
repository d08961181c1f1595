"""repro_torch's host copies of the paper's analytic forms and helpers
(classic SHP constants, p_write, the log approximations, cost_curve,
solve_separable_terms, single_tier_bounds, brute_force_plan_ntier, the
drifted / GRN / adversarial traces, the AWS topology presets,
peak_occupancy_suffix, evacuation_boundaries and the two-tier shims)
against the JAX package's originals, on the reference tests' own inputs.

Tolerance: exact. The copies run the same NumPy code, so every float is
compared with == (arrays with ``np.array_equal``).
"""
import itertools
import warnings

import numpy as np
import pytest

from repro.core import compat as j_compat
from repro.core import constraints as j_cons
from repro.core import costs as j_costs
from repro.core import placement as j_place
from repro.core import shp as j_shp
from repro.core import simulator as j_sim
from repro.core import topology as j_topo
from repro.streams import metering as j_meter
from repro_torch.core import compat as t_compat
from repro_torch.core import constraints as t_cons
from repro_torch.core import costs as t_costs
from repro_torch.core import placement as t_place
from repro_torch.core import shp as t_shp
from repro_torch.core import simulator as t_sim
from repro_torch.core import topology as t_topo
from repro_torch.streams import metering as t_meter
from test_torch_host import build_constraints, build_model, draw_model, same

J = (j_costs, j_topo, j_cons)
T = (t_costs, t_topo, t_cons)


def test_classic_constants_and_write_laws_bit_equal():
    for n in (1000, 12_000, 10 ** 8):
        assert j_shp.classic_r_optimal(n) == t_shp.classic_r_optimal(n)
    assert j_shp.classic_p_best() == t_shp.classic_p_best()
    assert j_shp.classic_expected_writes() == t_shp.classic_expected_writes()
    i = np.arange(20)
    for k in (1, 3):
        assert np.array_equal(j_shp.p_write(i, k=k), t_shp.p_write(i, k=k))
    i = np.concatenate([np.arange(200), [999, 99_999, 10 ** 7]])
    for k in (1, 8, 64):
        assert np.array_equal(j_shp.expected_cum_writes_approx(i, k),
                              t_shp.expected_cum_writes_approx(i, k))


@pytest.mark.parametrize("migrate", [False, True])
@pytest.mark.parametrize("case", ["case_study_1", "case_study_2"])
def test_cost_curve_bit_equal(case, migrate):
    jm, tm = getattr(j_costs, case)(), getattr(t_costs, case)()
    assert np.array_equal(j_shp.cost_curve(jm, migrate, num=2048),
                          t_shp.cost_curve(tm, migrate, num=2048))


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("t", [3, 4])
def test_solve_separable_terms_bit_equal(t, constrained):
    """A custom separable objective (the planner's terms plus a random
    per-candidate charge, some +inf) under the same compiled constraint
    structure in both packages."""
    rng = np.random.default_rng(10 * t + constrained)
    draws = [draw_model(rng, t) for _ in range(16)]
    out = []
    for pkg, shp in ((J, j_shp), (T, t_shp)):
        models = [build_model(pkg, d) for d in draws]
        cw = np.stack([m.cw for m in models])
        rpw = np.array([m.workload.reads_per_window for m in models])
        k = np.array([float(m.workload.k) for m in models])
        n = np.array([float(m.workload.n_docs) for m in models])
        lin = (rpw * k / n)[:, None] * np.stack([m.cr for m in models])
        kw = {}
        if constrained:
            comp = [shp.resolve_constraints(m, build_constraints(pkg, d))
                    for m, d in zip(models, draws)]
            kw = dict(cap_s=np.stack([c[0] for c in comp]),
                      lat_s=np.stack([c[1] for c in comp]),
                      slo=np.array([c[2] for c in comp]))
        obj = shp.BoundaryObjective(cw_s=cw, lin_s=lin, n=n, k=k, **kw)
        c = obj.candidates()
        extra = np.random.default_rng(5).uniform(0, 1e-3, c.shape)
        extra[:, ::7] = np.inf
        fs = [f + extra for f in obj.terms(c)]
        out.append(shp.solve_separable_terms(obj, fs, c))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


def test_single_tier_bounds_bit_equal():
    rng = np.random.default_rng(3)
    for t in (2, 3, 4):
        d = draw_model(rng, t)
        jm, tm = build_model(J, d), build_model(T, d)
        for tier in range(t):
            assert (j_shp.single_tier_bounds(jm, tier)
                    == t_shp.single_tier_bounds(tm, tier))


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("t", [2, 3, 4])
def test_brute_force_plan_ntier_bit_equal(t, constrained):
    rng = np.random.default_rng(20 + 2 * t + constrained)
    for _ in range(4):
        d = draw_model(rng, t)
        out = []
        for pkg, shp in ((J, j_shp), (T, t_shp)):
            cset = build_constraints(pkg, d) if constrained else None
            out.append(shp.brute_force_plan_ntier(build_model(pkg, d),
                                                  grid=16, constraints=cset))
        assert same(out[0], out[1])


def test_brute_force_generic_constraint_bit_equal():
    """The verifier's generic-constraint path (a ``feasible`` predicate
    evaluated row by row), at tests/test_constraints.py's input."""

    class NoMigration:
        def feasible(self, cm, bounds, migrate):
            return not migrate

    out = []
    for pkg, shp in ((J, j_shp), (T, t_shp)):
        costs, topology, cons = pkg
        m = topology.aws_efs_s3_glacier().cost_model(costs.WorkloadSpec(
            n_docs=int(1e8), k=int(1e5), doc_gb=1e-3, window_months=3.0))
        out.append((shp.brute_force_plan_ntier(m),
                    shp.brute_force_plan_ntier(
                        m, constraints=cons.ConstraintSet(NoMigration()))))
    assert same(out[0], out[1])


def test_drift_weights_and_drifted_trace_bit_equal():
    sched = [(4, 3.0), (7, 0.5)]
    assert np.array_equal(j_sim.drift_weights(10, sched),
                          t_sim.drift_weights(10, sched))
    for sim in (j_sim, t_sim):
        with pytest.raises(ValueError):
            sim.drift_weights(10, [(2, -1.0)])
    for n, sched in ((4000, [(2000, 6.0)]), (12_000, [(3000, 8.0)]),
                     (500, [(100, 2.0), (300, 0.25)])):
        a = j_sim.drifted_rank_trace(n, np.random.default_rng(2), sched)
        b = t_sim.drifted_rank_trace(n, np.random.default_rng(2), sched)
        assert np.array_equal(a, b)


def test_grn_and_adversarial_traces_bit_equal():
    a = j_sim.grn_entropy_trace(20_000, np.random.default_rng(3))
    b = t_sim.grn_entropy_trace(20_000, np.random.default_rng(3))
    assert np.array_equal(a, b)
    a = j_sim.grn_entropy_trace(500, np.random.default_rng(4), 0.4)
    b = t_sim.grn_entropy_trace(500, np.random.default_rng(4), 0.4)
    assert np.array_equal(a, b)
    for asc in (True, False):
        assert np.array_equal(j_sim.sorted_adversarial_trace(2000, asc),
                              t_sim.sorted_adversarial_trace(2000, asc))


PRESETS = [("aws_s3_tiering", {}),
           ("aws_s3_tiering", {"glacier_retrieval_per_gb": 0.05,
                               "ia_retrieval_per_gb": 0.02}),
           ("aws_efs_s3_glacier", {}),
           ("aws_archive_tiering", {}),
           ("aws_archive_tiering", {"min_storage": True,
                                    "flexible_latency_s": 3600.0})]


@pytest.mark.parametrize("name,kw", PRESETS)
def test_aws_presets_bit_equal(name, kw):
    """The cloud case-study topologies: cost arrays, latencies and the
    plans at tests/test_topology.py's and tests/test_online.py's
    workloads."""
    plans = []
    for pkg in (J, T):
        costs, topology, cons = pkg
        topo = getattr(topology, name)(**kw)
        out = [topo.name]
        for n, k, gb, months in ((int(1e8), int(1e5), 1e-3, 3.0),
                                 (200_000, 512, 1e-3, 1.0)):
            cm = topo.cost_model(costs.WorkloadSpec(
                n_docs=n, k=k, doc_gb=gb, window_months=months))
            shp = j_shp if pkg is J else t_shp
            out += [cm.cw, cm.cr, cm.cs, cm.read_latency,
                    shp.plan_placement_ntier(cm),
                    shp.plan_placement_ntier(cm, constraints=cons.ConstraintSet(
                        cons.ReadLatencySLO(60.0)))]
        plans.append(out)
    assert same(plans[0], plans[1])


def test_peak_occupancy_suffix_bit_equal():
    rng = np.random.default_rng(9)
    for t in (2, 3, 4):
        m = 32
        n = rng.uniform(1e3, 1e5, m)
        k = np.floor(rng.uniform(1, 200, m))
        bounds = np.sort(rng.uniform(0, 1, (m, t - 1)) * n[:, None], axis=1)
        hwm = rng.uniform(0, 150, (m, t))
        assert np.array_equal(
            j_cons.peak_occupancy_suffix(bounds, n, k, hwm),
            t_cons.peak_occupancy_suffix(bounds, n, k, hwm))
    # tests/test_online.py's scalar case
    assert np.array_equal(
        j_cons.peak_occupancy_suffix([4000.0], 12000.0, 64.0, [[64.0, 0.0]]),
        t_cons.peak_occupancy_suffix([4000.0], 12000.0, 64.0, [[64.0, 0.0]]))


def test_evacuation_boundaries_bit_equal():
    for bounds in ((100.0, 200.0, 300.0), (0.0, 50.0), (7.5,),
                   (10.0, 10.0, np.inf)):
        for tier, n in itertools.product(range(len(bounds) + 1),
                                         (None, 1000.0)):
            assert np.array_equal(
                j_cons.evacuation_boundaries(bounds, tier, n),
                t_cons.evacuation_boundaries(bounds, tier, n))
    for cons in (j_cons, t_cons):
        with pytest.raises(ValueError):
            cons.evacuation_boundaries((1.0, 2.0), 3)
        with pytest.raises(ValueError):
            cons.evacuation_boundaries((), 0)
    assert t_cons.EMPTY.empty and same(j_cons.EMPTY, t_cons.EMPTY)


def test_two_tier_shims_warn_once_and_agree():
    assert (j_compat.TIER_A, j_compat.TIER_B) == (t_compat.TIER_A,
                                                  t_compat.TIER_B)
    assert (t_place.TIER_A, t_sim.TIER_B) == (0, 1)
    for place, meter, compat in ((j_place, j_meter, j_compat),
                                 (t_place, t_meter, t_compat)):
        compat._WARNED.clear()
        pols = (place.Policy(r=4.5, migrate_at_r=True), place.Policy(r=4.5),
                place.Policy(boundaries=(3.2, 9.0), migrate_at_r=True))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = [p.migration_index() for p in pols]
            consts = (meter.TIER_A, meter.TIER_B, meter.TIER_A)
        assert got == [5, None, 4] and consts == (0, 1, 0)
        # one warning per legacy API, whatever the number of calls
        assert [str(w.message).split(" is ")[0] for w in rec] == [
            "Policy.migration_index", "streams.metering.TIER_A",
            "streams.metering.TIER_B"]
        assert all(w.category is DeprecationWarning for w in rec)
        with pytest.raises(AttributeError):
            meter.NOT_A_NAME  # noqa: B018
