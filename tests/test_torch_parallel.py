"""repro_torch.parallel.fleet and everything that consults the fleet mesh,
on the CPU with ``FleetMesh``es of 2, 3 and 8 shards on ``"cpu"``.

The reference's own mesh path (tests/test_sharded.py) fails on this jax
(``shard_map(check_rep=)`` and ``jax.experimental.enable_x64`` are gone),
so the port is held to its own contract, the reference's: sharded
outputs are bit-identical to the unsharded run, at every fleet size,
divisible by the shard count or not. The unsharded port is held to the
reference by the other ``test_torch_*`` files. Where a reference piece
runs without a mesh, the port is held to it directly: the sharded
``obs.metrics`` layout, ``obs.jits.mesh_key``, the host water-filling law
``constraints.waterfill_grants``, and checkpoints written by the
reference's unsharded engine.

* engine: exact fleets at m in {5, 16, 33}, logmem fleets at m in
  {6, 13}, a re-planning fleet with cost attribution, and
  ``ingest_chunks`` against ``ingest`` — finals, every meter field,
  ``obs_snapshot``'s blocks, thresholds, tiers, bit for bit;
* the device planner and the device re-solve per shard against their
  unsharded runs (bit for bit) and the NumPy oracle (the float32 /
  float64 rules of tests/test_torch_plan_device.py);
* ``waterfill_sharded`` against ``waterfill_grants`` within the
  reference's tolerances (a hypothesis property, 25 examples), never
  oversubscribing, and ``planner.waterfill(mesh=)``'s dispatch;
* checkpoints restored across shard counts (1→4, 4→1, 4→3) and from
  the reference's unsharded engine onto 3 shards, resumed bit-equal to
  an uninterrupted run;
* the serving launcher with ``--mesh 2``, and the package's imports.

Tolerances: exact everywhere except the water-filling, whose bisection
is held to the exact host λ as the reference holds its own (rtol and
atol 1e-7; never above the budget by more than 1e-12 relative).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import constraints as j_cons
from repro.obs import Observability as JObservability
from repro.obs import ObsConfig as JObsConfig
from repro.obs import jits as j_jits
from repro.obs import metrics as j_metrics
from repro.resilience import FleetCheckpointer as JCheckpointer
from repro.streams import StreamEngine as JStreamEngine
from repro.streams import StreamSpec as JStreamSpec
from repro_torch.core import costs as t_costs
from repro_torch.core import shp as t_shp
from repro_torch.core import simulator as t_sim
from repro_torch.obs import Observability, ObsConfig
from repro_torch.obs import jits as t_jits
from repro_torch.obs import metrics as t_metrics
from repro_torch.online import DriftConfig, ReplanConfig, replan_device
from repro_torch.parallel import fleet
from repro_torch.resilience import FleetCheckpointer
from repro_torch.streams import StreamEngine, StreamSpec, planner
from test_torch_plan_device import assert_f32_plan, assert_f64_plan

ROOT = os.path.join(os.path.dirname(__file__), "..")
METER_FIELDS = ("observed", "writes", "deletes", "reads", "boundaries",
                "migrations", "relocations", "occupancy_hwm")


def cpu_mesh(shards):
    return fleet.fleet_mesh(shards, device="cpu")


def mixed_ingest(engines, specs, traces, batch, rng):
    """tests/test_sharded.py's ``_mixed_ingest``: shuffled mixed batches
    of every stream's next ``batch`` docs."""
    sids = np.array([s.stream_id for s in specs])
    m, docs = traces.shape
    for t in range(0, docs, batch):
        mixed_sids = np.repeat(sids, batch)
        mixed_dids = np.tile(np.arange(t, t + batch), m)
        mixed_scores = traces[:, t:t + batch].reshape(-1)
        perm = rng.permutation(mixed_sids.size)
        for e in engines:
            e.ingest(mixed_sids[perm], mixed_scores[perm], mixed_dids[perm])


def assert_engines_identical(ref, shd):
    """Finals, every meter ledger, the obs snapshot's engine, meter and
    costs blocks, thresholds and finalize-time tiers, bit for bit."""
    t_ref, t_shd = ref.finalize_tiers(), shd.finalize_tiers()
    assert t_ref.keys() == t_shd.keys()
    for sid in t_ref:
        for key in ("ids", "tiers", "counts"):
            np.testing.assert_array_equal(t_ref[sid][key], t_shd[sid][key])
    s_ref, s_shd = ref.finalize(), shd.finalize()
    assert s_ref.keys() == s_shd.keys()
    for sid in s_ref:
        np.testing.assert_array_equal(s_ref[sid], s_shd[sid])
    for name in METER_FIELDS:
        np.testing.assert_array_equal(getattr(ref.meter, name),
                                      getattr(shd.meter, name),
                                      err_msg=name)
    o_ref, o_shd = ref.obs_snapshot(), shd.obs_snapshot()
    for block in ("fleet", "engine", "meter", "costs"):
        assert o_ref.get(block) == o_shd.get(block), block
    assert ref.thresholds() == shd.thresholds()


def assert_states_equal(ref, shd):
    """``states()`` leaf by leaf: the sharded engine gathers its shards'
    rows with the padding cut."""
    for a, b in zip(ref.states(), shd.states()):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the mesh and its row helpers
# ---------------------------------------------------------------------------

def test_fleet_mesh_shapes():
    assert fleet.fleet_mesh(1, device="cpu") is None
    mesh = cpu_mesh(3)
    assert fleet.n_shards(mesh) == 3 and fleet.n_shards(None) == 1
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert fleet.fleet_mesh(device=["cpu", "cpu"]).devices == \
        (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="2 shards but 3 devices"):
        fleet.fleet_mesh(2, device=["cpu"] * 3)
    with pytest.raises(ValueError, match="number of shards"):
        fleet.fleet_mesh(device="cpu")


def test_fleet_mesh_needs_the_cards(monkeypatch):
    """Without device= the shards are visible CUDA cards; asking for more
    than are visible raises, as the reference does for devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fleet.fleet_mesh() is None
    with pytest.raises(ValueError, match="only 0 CUDA devices"):
        fleet.fleet_mesh(2)


def test_active_mesh_is_scoped_and_thread_local():
    import threading
    mesh = cpu_mesh(2)
    assert fleet.get_fleet_mesh() is None
    with fleet.use_fleet_mesh(mesh):
        assert fleet.get_fleet_mesh() is mesh
        seen = []
        th = threading.Thread(target=lambda: seen.append(
            fleet.get_fleet_mesh()))
        th.start()
        th.join(timeout=10)
        assert not th.is_alive() and seen == [None]
        with fleet.use_fleet_mesh(None):
            assert fleet.get_fleet_mesh() is None
        assert fleet.get_fleet_mesh() is mesh
    assert fleet.get_fleet_mesh() is None


@pytest.mark.parametrize("m,shards", [(1, 2), (5, 3), (7, 8), (16, 8),
                                      (33, 2)])
def test_pad_rows_and_blocks(m, shards):
    pm = fleet.pad_rows(m, shards)
    assert pm % shards == 0 and pm >= max(m, shards)
    assert pm - m < shards or m < shards
    blocks = fleet.row_blocks(m, shards)
    assert len(blocks) == shards
    assert blocks[0][0] == 0 and blocks[-1][1] == m
    for (lo, hi), (lo2, _) in zip(blocks, blocks[1:]):
        assert lo <= hi == lo2


def test_shard_rows_round_trip():
    """Each shard gets a copy of its contiguous block (not a view), and
    gather_rows restores the rows with the padding cut."""
    from repro_torch.streams import engine as t_eng
    mesh = cpu_mesh(3)
    st = t_eng.init(6, 4, device="cpu")
    st = st._replace(scores=torch.arange(24, dtype=torch.float32)
                     .reshape(6, 4))
    parts = fleet.shard_rows(mesh, st)
    assert [p.scores.shape[0] for p in parts] == [2, 2, 2]
    parts[0].scores[0, 0] = -1.0
    assert st.scores[0, 0] == 0.0  # a copy, not a view
    back = fleet.gather_rows(parts, 5)
    assert back.scores.shape == (5, 4)
    assert torch.equal(back.scores[1:], st.scores[1:5])
    assert fleet.shard_rows(None, st) == [st]
    with pytest.raises(ValueError, match="multiple"):
        fleet.shard_rows(mesh, torch.zeros(4))


def test_parallel_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.parallel\n"
            "import repro_torch.parallel.fleet\n"
            "bad = [n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or "
            "n.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout


# ---------------------------------------------------------------------------
# engine step: sharded == unsharded, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3, 8])
@pytest.mark.parametrize("m", [5, 16, 33])
def test_engine_sharded_bit_identity(m, shards):
    """Heterogeneous fleet (two K buckets, M not a multiple of the shard
    count) through shuffled mixed batches (tests/test_sharded.py's)."""
    rng = np.random.default_rng(100 + m)

    def build(mesh):
        specs = [StreamSpec(stream_id=100 + i, k=(4 if i % 2 else 8),
                            r=24.0) for i in range(m)]
        return StreamEngine(specs, obs=Observability(ObsConfig()),
                            mesh=mesh, device="cpu"), specs

    ref, specs = build(None)
    shd, _ = build(cpu_mesh(shards))
    assert shd._shards == shards
    traces = rng.standard_normal((m, 48)).astype(np.float32)
    mixed_ingest([ref, shd], specs, traces, batch=6, rng=rng)
    assert_states_equal(ref, shd)
    assert_engines_identical(ref, shd)


@pytest.mark.parametrize("shards", [2, 3, 8])
@pytest.mark.parametrize("m", [6, 13])
def test_engine_sharded_logmem_bit_identity(m, shards):
    """Mixed exact + logmem fleet whose logmem bucket gets pad rows: the
    pad rows stay inert (seen 0) through the threshold updates."""
    rng = np.random.default_rng(200 + m)

    def build(mesh):
        specs = [StreamSpec(stream_id=i, k=32, r=48.0, engine="logmem")
                 if i % 3 == 2 else StreamSpec(stream_id=i, k=4, r=48.0)
                 for i in range(m)]
        return StreamEngine(specs, obs=Observability(ObsConfig()),
                            mesh=mesh, device="cpu"), specs

    ref, specs = build(None)
    shd, _ = build(cpu_mesh(shards))
    traces = rng.standard_normal((m, 96)).astype(np.float32)
    mixed_ingest([ref, shd], specs, traces, batch=8, rng=rng)
    assert_states_equal(ref, shd)
    assert_engines_identical(ref, shd)
    lm = [bi for bi, b in enumerate(shd.buckets) if b.engine == "logmem"]
    assert len(lm) == 1
    seen = torch.cat([p.seen for p in shd._states[lm[0]]])
    assert fleet.pad_rows(shd.buckets[lm[0]].m, shards) == seen.shape[0]
    assert (seen[shd.buckets[lm[0]].m:] == 0).all()


def two_tier_model(n=2048, k=16):
    """tests/test_sharded.py's ``_two_tier_model`` in the port."""
    wl = t_costs.WorkloadSpec(n_docs=n, k=k, doc_gb=1e-4, window_months=0.5)
    hot = t_costs.TierCosts("hot", put_per_doc=1e-6, get_per_doc=2.7e-4,
                            storage_per_gb_month=0.05)
    cold = t_costs.TierCosts("cold", put_per_doc=8e-5, get_per_doc=1e-6,
                             storage_per_gb_month=0.02)
    return t_costs.TwoTierCostModel(tier_a=hot, tier_b=cold, workload=wl)


@pytest.mark.parametrize("shards", [2, 3])
def test_engine_sharded_replan_observed_bit_identity(shards):
    """Re-planning with cost attribution under the mesh: drift and cost
    ledgers ride sharded through the step, the suffix re-solve runs per
    shard through ``replan_device`` (pinned), and the events,
    boundaries, ledgers and snapshots are bitwise the unsharded run's."""
    rng = np.random.default_rng(7)
    m, n, k, batch = 5, 2048, 16, 64
    cm = two_tier_model(n=n, k=k)
    traces = np.stack([t_sim.drifted_rank_trace(n, rng, [(512, 8.0)])
                       for _ in range(m)]).astype(np.float32)

    def build(mesh):
        specs = [StreamSpec(stream_id=i, k=k, cost_model=cm)
                 for i in range(m)]
        eng = StreamEngine(
            specs, obs=Observability(ObsConfig(costs=True)), mesh=mesh,
            replan=ReplanConfig(drift=DriftConfig(alpha=0.05)),
            device="cpu")
        eng._replanner.backend = "device"
        return eng, specs

    ref, specs = build(None)
    shd, _ = build(cpu_mesh(shards))
    calls = []
    solve = replan_device.solve_group

    def counted(*args, **kw):
        calls.append(fleet.get_fleet_mesh())
        return solve(*args, **kw)

    replan_device.solve_group = counted
    try:
        mixed_ingest([ref, shd], specs, traces, batch=batch, rng=rng)
    finally:
        replan_device.solve_group = solve
    assert shd.mesh in calls and None in calls  # each engine's own layout
    assert len(ref.replan_events) == len(shd.replan_events) > 0
    assert ref.replan_events == shd.replan_events
    assert ref.drift_scores() == shd.drift_scores()
    summ_ref, summ_shd = ref.cost_summary(), shd.cost_summary()
    for key in ("total", "planned", "regret"):
        np.testing.assert_array_equal(summ_ref[key], summ_shd[key])
    assert_engines_identical(ref, shd)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_ingest_chunks_equals_ingest(shards):
    """Sharded ``ingest_chunks`` over dense chunks lands the unsharded
    engine's state after the same docs through the router (``ingest``)."""
    rng = np.random.default_rng(3)
    m, k, w, chunks = 12, 8, 16, 6

    def build(mesh):
        specs = [StreamSpec(stream_id=i, k=k, r=40.0) for i in range(m)]
        return StreamEngine(specs, obs=Observability(ObsConfig()),
                            mesh=mesh, device="cpu")

    ref, shd = build(None), build(cpu_mesh(shards))
    dense = []
    for c in range(chunks):
        sc = rng.standard_normal((m, w)).astype(np.float32)
        ids = np.tile(np.arange(c * w, (c + 1) * w, dtype=np.int32), (m, 1))
        dense.append([(sc, ids)])
        ref.ingest(np.repeat(np.arange(m), w), sc.reshape(-1),
                   ids.reshape(-1))
    assert shd.ingest_chunks(iter(dense)) == chunks
    assert shd.chunks_ingested == ref.chunks_ingested == chunks
    assert_states_equal(ref, shd)
    assert_engines_identical(ref, shd)


def test_tier_outage_sharded_bit_identity():
    """The row-addressed outage path (evacuation, ledger bounds, drift
    resets) maps global rows to (bucket, shard, row) as the unsharded
    engine maps them to (bucket, row)."""
    rng = np.random.default_rng(11)
    m, k, w = 10, 8, 8

    def build(mesh):
        specs = [StreamSpec(stream_id=i, k=k, boundaries=(16.0, 64.0))
                 for i in range(m)]
        return StreamEngine(specs, obs=Observability(ObsConfig(costs=True)),
                            mesh=mesh, device="cpu")

    ref, shd = build(None), build(cpu_mesh(3))
    for c in range(10):
        sc = rng.standard_normal((m, w)).astype(np.float32)
        ids = np.tile(np.arange(c * w, (c + 1) * w, dtype=np.int32), (m, 1))
        for e in (ref, shd):
            e.ingest_dense([(sc, ids)])
        if c == 4:
            s_ref, s_shd = ref.tier_outage(1), shd.tier_outage(1)
            assert s_ref == s_shd and s_ref["rows_evacuated"] > 0
    assert_engines_identical(ref, shd)


# ---------------------------------------------------------------------------
# planner entry points: sharded == unsharded, bitwise
# ---------------------------------------------------------------------------

def plan_inputs(rng, m, t=3):
    """tests/test_sharded.py's ``_plan_inputs``."""
    cw = rng.uniform(0.5, 2.0, (m, t))
    cr = rng.uniform(0.1, 1.0, (m, t))
    cs = rng.uniform(0.01, 0.2, (m, t))
    n = rng.integers(50, 400, m).astype(np.float64)
    k = rng.integers(2, 16, m).astype(np.float64)
    rpw = rng.uniform(0.5, 4.0, m)
    return cw, cr, cs, n, k, rpw


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("m,shards", [(7, 8), (64, 3), (1000, 2)])
def test_plan_sharded_bit_identity(m, shards, constrained):
    """The device planner under an active mesh solves each shard's block
    on its device; plans equal the unsharded device plan bit for bit and
    meet the NumPy oracle (float32 unconstrained, float64 constrained)."""
    rng = np.random.default_rng(m)
    args = plan_inputs(rng, m)
    kw = {}
    if constrained:
        cap = np.full((m, 3), np.inf)
        cap[:, 0] = rng.uniform(20, 80, m)
        slo = np.full(m, np.inf)
        slo[::3] = rng.uniform(0.5, 2.0, len(slo[::3]))
        kw = dict(cap=cap, lat=rng.uniform(0.1, 1.0, (m, 3)), slo=slo)
    ref = t_shp.plan_ntier_arrays(*args, backend="device", device="cpu",
                                  **kw)
    with fleet.use_fleet_mesh(cpu_mesh(shards)):
        out = t_shp.plan_ntier_arrays(*args, backend="device", **kw)
    for key in ("total", "bounds", "migrate"):
        np.testing.assert_array_equal(ref[key], out[key], err_msg=key)
    oracle = t_shp.plan_ntier_arrays_numpy(*args, **kw)
    (assert_f64_plan if constrained else assert_f32_plan)(args, oracle, out)


def test_replan_device_sharded_bit_identity():
    """tests/test_sharded.py's re-solve fixture: the R flagged rows split
    over the shards, each block re-solved on its device."""
    rng = np.random.default_rng(2)
    r = 11
    cw, cr, cs, n, k, rpw = plan_inputs(rng, r)
    cap = np.full((r, 3), np.inf)
    cap[:, 0] = rng.uniform(20, 80, r)
    lat = rng.uniform(0.1, 1.0, (r, 3))
    slo = np.full(r, np.inf)
    n0 = np.minimum(n * 0.5, n - 1)
    rho = rng.uniform(0.5, 1.5, r)
    b0 = np.sort(rng.uniform(0, 1, (r, 2)), axis=1) * n[:, None]
    args = (cw, cr, cs, n, k, rpw, cap, lat, slo, n0, rho, b0)
    ref = replan_device.solve_group(*args, device="cpu")
    for shards in (2, 3, 8):
        with fleet.use_fleet_mesh(cpu_mesh(shards)):
            out = replan_device.solve_group(*args)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(a, b)


def test_plan_fleet_mixed_activates_the_mesh(monkeypatch):
    """``plan_fleet_mixed(mesh=)`` makes the mesh active for its solves
    and restores the previous one afterwards."""
    from repro_torch.core import topology as t_topo
    seen = []
    solve = t_shp.plan_ntier_arrays

    def spy(*args, **kw):
        seen.append(fleet.get_fleet_mesh())
        return solve(*args, **kw)

    monkeypatch.setattr(t_shp, "plan_ntier_arrays", spy)
    models = [t_topo.hbm_dram_disk_preset(n_docs=200, k=8, doc_gb=1e-4,
                                          window_seconds=30.0 * (1 + i))
              for i in range(5)]
    mesh = cpu_mesh(2)
    plain = planner.plan_fleet_mixed(models, device="cpu")
    shd = planner.plan_fleet_mixed(models, mesh=mesh, device="cpu")
    assert seen and seen[-1] is mesh and seen[0] is None
    assert fleet.get_fleet_mesh() is None
    assert plain.boundaries == shd.boundaries
    np.testing.assert_array_equal(plain.totals, shd.totals)


# ---------------------------------------------------------------------------
# cross-shard water-filling
# ---------------------------------------------------------------------------

def check_waterfill_never_oversubscribes(seed, shards):
    """tests/test_sharded.py's property, against the host law."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 60))
    desired = rng.uniform(0.0, 50.0, m)
    desired[rng.random(m) < 0.2] = 0.0  # zero-desire rows draw nothing
    budget = float(desired.sum() * rng.uniform(0.1, 1.4))
    grants = fleet.waterfill_sharded(desired, budget, cpu_mesh(shards))
    assert grants.shape == (m,)
    assert (grants <= desired + 1e-9).all()
    assert grants.sum() <= budget * (1 + 1e-12) + 1e-9
    if desired.sum() <= budget:
        np.testing.assert_allclose(grants, desired, rtol=1e-9)
    exact = j_cons.waterfill_grants(desired, budget)
    np.testing.assert_allclose(grants, exact, rtol=1e-7, atol=1e-7)


@given(seed=st.integers(0, 2**31 - 1), shards=st.sampled_from([2, 3, 8]))
@settings(max_examples=25, deadline=None)
def test_waterfill_never_oversubscribes_property(seed, shards):
    check_waterfill_never_oversubscribes(seed, shards)


def test_planner_waterfill_dispatches_to_mesh(monkeypatch):
    desired = np.array([10.0, 0.0, 30.0, 5.0])
    host = planner.waterfill(desired, 20.0)
    calls = []
    sharded = fleet.waterfill_sharded

    def spy(*args):
        calls.append(args[2])
        return sharded(*args)

    monkeypatch.setattr(fleet, "waterfill_sharded", spy)
    mesh = cpu_mesh(3)
    shd = planner.waterfill(desired, 20.0, mesh=mesh)
    assert calls == [mesh]
    np.testing.assert_allclose(host, shd, rtol=1e-9, atol=1e-9)
    assert float(shd.sum()) <= 20.0 * (1 + 1e-12)
    planner.waterfill(desired, 20.0, mesh=None)
    assert calls == [mesh]  # no mesh: the host law


# ---------------------------------------------------------------------------
# sharded metrics layout and mesh_key (the reference's run without a mesh)
# ---------------------------------------------------------------------------

def sharded_counts():
    counts = np.zeros((3, t_metrics.N_SLOTS), np.int32)
    counts[:, t_metrics.DOCS] = [10, 20, 30]
    counts[:, t_metrics.ADMITS] = [3, 0, 7]
    counts[:, t_metrics.CHUNKS] = [4, 4, 4]
    counts[:, t_metrics.DRIFT_FIRED] = [1, 0, 2]
    counts[:, t_metrics.BAR_CANDIDATES] = [10, 20, 30]
    counts[:, t_metrics.BAR_PASSES] = [5, 1, 9]
    score = np.array([0.5, 2.0, 1.0], np.float32)
    return counts, score


def test_metrics_sharded_snapshot_matches_reference():
    """init(shards=3), snapshot's cross-shard aggregation (sums; max for
    CHUNKS and the drift high-water mark), shard_local / shard_pack, and
    the canonical form both ways, equal to repro.obs.metrics's."""
    counts, score = sharded_counts()
    j_ms = j_metrics.init(shards=3)
    t_ms = t_metrics.init(device="cpu", shards=3)
    assert t_ms.sharded and j_ms.sharded
    assert tuple(t_ms.counts.shape) == tuple(np.shape(j_ms.counts))
    assert tuple(t_ms.drift_score_max.shape) == \
        tuple(np.shape(j_ms.drift_score_max))
    j_ms = j_ms._replace(counts=counts, drift_score_max=score)
    t_ms = t_metrics.MetricsState(torch.tensor(counts), torch.tensor(score))
    assert t_metrics.snapshot(t_ms) == j_metrics.snapshot(j_ms)
    for a, b in zip(t_metrics.to_canonical(t_ms),
                    j_metrics.to_canonical(j_ms)):
        np.testing.assert_array_equal(a, b)
    local = t_metrics.shard_local(t_ms)
    j_local = j_metrics.shard_local(j_ms)
    for a, b in zip(local, j_local):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    packed = t_metrics.shard_pack(local)
    assert not local.sharded and packed.sharded
    for a, b in zip(packed, j_metrics.shard_pack(j_local)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c, s = j_metrics.to_canonical(j_ms)
    for shards in (0, 2, 3):
        t_back = t_metrics.from_canonical(c, s, device="cpu", shards=shards)
        j_back = j_metrics.from_canonical(c, s, shards=shards)
        for a, b in zip(t_back, j_back):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert t_metrics.snapshot(t_back) == j_metrics.snapshot(j_back)


def test_metrics_flat_layout_unchanged():
    t_ms = t_metrics.init(device="cpu")
    assert not t_ms.sharded
    assert tuple(t_ms.counts.shape) == (t_metrics.N_SLOTS,)
    assert tuple(t_ms.drift_score_max.shape) == ()


def test_mesh_key_matches_reference():
    """The reference's mesh_key reads ``axis_names`` and the device
    grid's shape; on a stand-in of a D-device mesh it gives the key the
    port's gives for a D-shard FleetMesh."""
    assert t_jits.mesh_key(None) == j_jits.mesh_key(None) == ()
    for shards in (2, 3, 8):
        stand_in = types.SimpleNamespace(axis_names=("fleet",),
                                         devices=np.empty((shards,)))
        key = t_jits.mesh_key(cpu_mesh(shards))
        assert key == j_jits.mesh_key(stand_in) == (("fleet", shards),)


# ---------------------------------------------------------------------------
# checkpoint resharding: a snapshot restores onto any shard count
# ---------------------------------------------------------------------------

M_CK, BATCH_CK, CHUNKS_CK, CUT_CK = 7, 6, 12, 7


def ck_specs(spec):
    """tests/test_sharded.py's reshard fleet: exact + logmem, M not a
    shard multiple."""
    return [spec(stream_id=i, k=32, r=48.0, engine="logmem")
            if i % 3 == 2 else spec(stream_id=i, k=4, r=48.0)
            for i in range(M_CK)]


def ck_traces():
    rng = np.random.default_rng(900)
    return rng.standard_normal((M_CK, BATCH_CK * CHUNKS_CK)
                               ).astype(np.float32)


def ck_feed(engine, traces, t):
    perm = np.random.default_rng(7000 + t).permutation(M_CK * BATCH_CK)
    sids = np.repeat(np.arange(M_CK), BATCH_CK)[perm]
    dids = np.tile(np.arange(t * BATCH_CK, (t + 1) * BATCH_CK), M_CK)[perm]
    scores = traces[:, t * BATCH_CK:(t + 1) * BATCH_CK].reshape(-1)[perm]
    engine.ingest(sids, scores, dids)


def ck_build(shards):
    mesh = cpu_mesh(shards) if shards > 1 else None
    return StreamEngine(ck_specs(StreamSpec),
                        obs=Observability(ObsConfig()), mesh=mesh,
                        device="cpu")


def uninterrupted(traces):
    ref = ck_build(1)
    for t in range(CHUNKS_CK):
        ck_feed(ref, traces, t)
    return ref


@pytest.mark.parametrize("src,dst", [(1, 4), (4, 1), (4, 3)])
def test_checkpoint_reshard_bit_identity(tmp_path, src, dst):
    """Written at ``src`` shards, restored onto ``dst`` and resumed:
    finals, ledgers and snapshots equal an uninterrupted unsharded run,
    and the restore re-pads with inert rows."""
    traces = ck_traces()
    ref = uninterrupted(traces)
    eng = ck_build(src)
    for t in range(CUT_CK):
        ck_feed(eng, traces, t)
    FleetCheckpointer(str(tmp_path), every=0).save(eng, blocking=True)
    back = ck_build(dst)
    FleetCheckpointer(str(tmp_path)).restore(back)
    assert back.chunks_ingested == CUT_CK
    for t in range(CUT_CK, CHUNKS_CK):
        ck_feed(back, traces, t)
    assert_states_equal(ref, back)
    assert_engines_identical(ref, back)
    if dst > 1:
        for bi, b in enumerate(back.buckets):
            seen = torch.cat([p.seen for p in back._states[bi]])
            assert (seen[b.m:] == 0).all()


def test_reference_checkpoint_restores_onto_three_shards(tmp_path):
    """A checkpoint the reference's unsharded engine wrote restores onto
    a port engine of 3 shards, which resumes bit-equal to the port's
    uninterrupted run."""
    traces = ck_traces()
    ref = uninterrupted(traces)
    j_eng = JStreamEngine(ck_specs(JStreamSpec),
                          obs=JObservability(JObsConfig()))
    for t in range(CUT_CK):
        ck_feed(j_eng, traces, t)
    JCheckpointer(str(tmp_path), every=0).save(j_eng, blocking=True)
    back = ck_build(3)
    FleetCheckpointer(str(tmp_path)).restore(back)
    assert back.chunks_ingested == CUT_CK
    for t in range(CUT_CK, CHUNKS_CK):
        ck_feed(back, traces, t)
    assert_engines_identical(ref, back)


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------

def run_launcher(*extra):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--tenants", "4", "--requests", "24", "--gen-len", "6",
         "--prompt-len", "8", *extra],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launcher_mesh_retains_the_unsharded_sets():
    """``serve --mesh 2`` (2 shards on the CPU: no card is visible)
    retains each tenant's unsharded set and meters the same writes."""
    sharded = run_launcher("--mesh", "2")
    assert "fleet mesh: 2 shards on cpu (0 cards visible)" in sharded
    plain = run_launcher()

    def kept(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("tenant ", "fleet ledger",
                                  "per-stream strategies"))]

    assert kept(sharded) == kept(plain) and len(kept(plain)) == 6


def test_launcher_mesh_needs_tenants():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mesh", "2"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "--mesh requires --tenants > 1" in out.stderr
