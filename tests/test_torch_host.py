"""repro_torch host copies (planning math, simulator, meter) vs the JAX
package's originals, the import guard, and the device default.

Tolerance: exact everywhere. The copies run the same NumPy code, so plans,
totals and simulator results must be bit-equal (floats compared with ==).
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import costs as j_costs
from repro.core import constraints as j_cons
from repro.core import shp as j_shp
from repro.core import simulator as j_sim
from repro.core import placement as j_place
from repro.core import topology as j_topo
from repro.streams import planner as j_planner
from repro_torch.core import costs as t_costs
from repro_torch.core import constraints as t_cons
from repro_torch.core import shp as t_shp
from repro_torch.core import simulator as t_sim
from repro_torch.core import placement as t_place
from repro_torch.core import topology as t_topo
from repro_torch.streams import planner as t_planner

J = (j_costs, j_topo, j_cons)
T = (t_costs, t_topo, t_cons)


def same(a, b) -> bool:
    """Structural bit-equality across the two packages' plan objects."""
    if dataclasses.is_dataclass(a):
        return (type(a).__name__ == type(b).__name__ and all(
            same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


def draw_model(rng, t):
    """Numbers of a random t-tier model, built in either package by
    ``build_model``."""
    n = int(rng.integers(2_000, 200_000))
    return dict(
        tiers=[(tuple(10.0 ** rng.uniform(-8, -3, 3)),
                float(10.0 ** rng.uniform(-7, -3)),
                float(10.0 ** rng.uniform(-6, -2)),
                float(10.0 ** rng.uniform(-3, 2))) for _ in range(t)],
        n=n, k=int(rng.integers(1, max(2, n // 10))),
        doc_gb=float(rng.uniform(1e-4, 1.0)),
        months=float(rng.uniform(0.03, 3.0)),
        cap=(int(rng.integers(0, t)), float(rng.uniform(0.1, 2.0))))


def build_model(pkg, d):
    costs, topology, _ = pkg
    specs = tuple(
        topology.TierSpec(costs.TierCosts(f"t{i}", *c), xfer_in_per_gb=xi,
                          xfer_out_per_gb=xo, read_latency_s=lat)
        for i, (c, xi, xo, lat) in enumerate(d["tiers"]))
    wl = costs.WorkloadSpec(n_docs=d["n"], k=d["k"], doc_gb=d["doc_gb"],
                            window_months=d["months"])
    return topology.TierTopology(tiers=specs).cost_model(wl)


def build_constraints(pkg, d):
    _, _, cons = pkg
    tier, frac = d["cap"]
    return cons.ConstraintSet(cons.TierCapacity(tier, d["k"] * frac))


@pytest.fixture
def numpy_reference_planner():
    """The reference planner pinned to its NumPy solver (the solver the
    port's planner keeps on the CPU)."""
    prev = j_shp.set_planner_backend("numpy")
    yield
    j_shp.set_planner_backend(prev)


@pytest.mark.parametrize("case", ["case_study_1", "case_study_2"])
def test_case_studies_bit_equal(case):
    jm, tm = getattr(j_costs, case)(), getattr(t_costs, case)()
    for exact in (False, True):
        assert same(j_shp.plan_placement(jm, exact=exact),
                    t_shp.plan_placement(tm, exact=exact))
    assert same(j_shp.plan_placement_ntier(jm.as_ntier()),
                t_shp.plan_placement_ntier(tm.as_ntier()))
    assert same(j_place.optimal_policy(jm), t_place.optimal_policy(tm))


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("t", [2, 3, 4])
def test_random_fleets_bit_equal(t, constrained, numpy_reference_planner):
    rng = np.random.default_rng(100 * t + constrained)
    draws = [draw_model(rng, t) for _ in range(24)]
    plans = []
    for pkg, mod in ((J, j_planner), (T, t_planner)):
        models = [build_model(pkg, d) for d in draws]
        cons = ([build_constraints(pkg, d) for d in draws]
                if constrained else None)
        plans.append(mod.plan_fleet_mixed(models, constraints=cons))
    assert same(plans[0], plans[1])


def test_fleet_shared_capacity_waterfill_bit_equal(numpy_reference_planner):
    rng = np.random.default_rng(7)
    draws = [draw_model(rng, 3) for _ in range(16)]
    plans = []
    for pkg, mod in ((J, j_planner), (T, t_planner)):
        _, _, cons = pkg
        shared = cons.ConstraintSet(cons.TierCapacity(
            0, 0.3 * sum(d["k"] for d in draws), shared=True))
        plans.append(mod.plan_fleet_mixed(
            [build_model(pkg, d) for d in draws], constraints=shared))
    assert same(plans[0], plans[1])


@pytest.mark.parametrize("migrate", [False, True])
def test_simulator_bit_equal(migrate):
    rng = np.random.default_rng(int(migrate))
    d = draw_model(rng, 3)
    n = 400
    for pkg, sim, place in ((J, j_sim, j_place), (T, t_sim, t_place)):
        cm = build_model(pkg, dict(d, n=n, k=8))
        pol = place.Policy(boundaries=(60.0, 220.5), migrate_at_r=migrate)
        trace = sim.random_rank_trace(n, np.random.default_rng(3))
        if sim is j_sim:
            ref = sim.simulate(trace, 8, pol, cost_model=cm)
        else:
            got = sim.simulate(trace, 8, pol, cost_model=cm)
    assert same(ref, got)


def test_device_planner_and_sharding_raise(monkeypatch):
    cw = np.ones((2, 3))
    with pytest.raises(ValueError, match="'device'"):
        t_shp.plan_ntier_arrays(cw, cw, cw, np.full(2, 100.0),
                                np.full(2, 4.0), np.ones(2), backend="jax")
    # the planner's mesh= runs (tests/test_torch_parallel.py); what raises
    # is a mesh of more cards than are visible, with no CPU fallback
    from repro_torch.parallel import fleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 CUDA devices"):
        t_planner.waterfill(np.ones(3), 1.0, mesh=fleet.fleet_mesh(2))
    mesh = fleet.fleet_mesh(2, device="cpu")
    plan = t_planner.plan_fleet_mixed([t_costs.case_study_1()], mesh=mesh,
                                      device="cpu")
    assert plan.boundaries == t_planner.plan_fleet_mixed(
        [t_costs.case_study_1()], device="cpu").boundaries


def test_import_guard_no_jax_no_reference_package():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
        "need = ['repro_torch.models.lm', 'repro_torch.models.attention',"
        " 'repro_torch.launch.serve', 'repro_torch.data.curation',"
        " 'repro_torch.configs.llama3_2_1b', 'repro_torch.core.interestingness',"
        " 'repro_torch.kernels.flash_attention.ops',"
        " 'repro_torch.kernels.entropy_scores.ops',"
        " 'repro_torch.kernels.plan_solve.ref', 'repro_torch.obs.timers',"
        " 'repro_torch.online.drift', 'repro_torch.online.replan',"
        " 'repro_torch.online.replan_device', 'repro_torch.online.admission',"
        " 'repro_torch.online.evaluate']\n"
        "assert all(n in sys.modules for n in need), need\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from repro_torch.core import topk
    from repro_torch.streams import engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = [engine.StreamSpec(stream_id=0, k=4, r=10.0)]
    for call in (lambda: topk.init(4), lambda: engine.init(2, 4),
                 lambda: engine.StreamEngine(spec),
                 lambda: engine.state_from_numpy(
                     np.zeros((1, 4)), np.zeros((1, 4)), np.zeros(1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert topk.init(4, device="cpu").scores.device.type == "cpu"
    eng = engine.StreamEngine(spec, device="cpu")
    assert eng.states()[0].ids.device.type == "cpu"
