"""examples_torch/quickstart.py on the CPU against examples/quickstart.py.

* The host sections (the case study's plan: r*/N, E[cost] and every
  candidate; the trace-driven validation: simulated and analytic cost,
  writes per tier, evictions) equal the reference's exactly: the same
  closed forms and the same seeded trace in float64.
* The training section starts from the reference's own
  ``init_train_state(cfg, PRNGKey(0), reservoir_k=16)``, carried across
  by ``runtime.steps.from_reference_train_state``: step 0's per-example
  NLL within 1e-5 relative of the reference's ``train_step`` (float32
  sums in another order), the device reservoir equal to the host
  curator, and the curator's writes, evictions and survivors equal to a
  ``core.simulator`` replay of the NLL stream it saw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from example_scripts import (assert_import_guard, assert_no_card_stops,
                             load, printed, start_import_guard)
from repro import configs as r_configs
from repro.core import costs as r_costs
from repro.core import placement as r_place
from repro.core import shp as r_shp
from repro.core import simulator as r_sim
from repro.data.pipeline import StreamLoader as RLoader
from repro.configs.base import ShapeConfig as RShape
from repro.runtime import steps as r_steps
from repro_torch.core import placement as t_place
from repro_torch.core import simulator as t_sim
from repro_torch.runtime import steps as t_steps

port = load("examples_torch/quickstart.py", "port_quickstart")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/quickstart.py",
                              "repro_torch.runtime.steps")


@pytest.fixture(scope="module")
def run(guard):
    rcfg = r_configs.get_config("llama3.2-1b", reduced=True)
    state = jax.jit(lambda key: r_steps.init_train_state(
        rcfg, key, reservoir_k=16))(jax.random.PRNGKey(0))
    t_state = t_steps.from_reference_train_state(
        jax.tree.map(np.asarray, state), port.configs.get_config(
            "llama3.2-1b", reduced=True), device="cpu")
    res, lines = printed(port.run, port.parse_args(["--device", "cpu"]),
                         t_state)
    loader = RLoader(rcfg, RShape("quick", seq_len=32, global_batch=8,
                                  kind="train"), seed=0)
    batch = jax.tree.map(jnp.asarray, loader.batch_for_step(0))
    _, metrics = jax.jit(lambda st, b: r_steps.train_step(st, b, rcfg))(
        state, batch)
    return res, lines, np.asarray(metrics["per_example_nll"])


def test_flags_and_defaults():
    assert port.parse_args([]).device == "cuda"


def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args([]), tmp_path)


def test_host_sections_equal_the_reference(run):
    res, lines, _ = run
    cm = r_costs.case_study_1()
    plan = r_shp.plan_placement(cm)
    assert res.plan.strategy == plan.strategy
    assert res.plan.best.r_over_n == plan.best.r_over_n
    assert res.plan.best.total == plan.best.total
    assert [(c.strategy, c.total) for c in res.plan.candidates] == \
        [(c.strategy, c.total) for c in plan.candidates]
    small = cm.replace(workload=r_costs.WorkloadSpec(
        n_docs=50_000, k=500, doc_gb=cm.workload.doc_gb,
        window_months=cm.workload.window_months))
    pol = r_place.optimal_policy(small)
    sim = r_sim.simulate(r_sim.grn_entropy_trace(
        50_000, np.random.default_rng(0)), 500, pol, small,
        storage_bound=True)
    assert res.sim.cost_total == sim.cost_total
    assert res.analytic == r_shp.cost_no_migration(small, pol.r,
                                                   exact=True).total
    np.testing.assert_array_equal(res.sim.writes_per_tier,
                                  sim.writes_per_tier)
    assert res.sim.evictions == sim.evictions
    assert lines[0] == "== Case study 1 (AWS S3 -> Azure Blob) =="
    assert f"  writes A/B: {sim.writes_per_tier.tolist()}  evictions: " \
        f"{sim.evictions}" in lines


def test_step_zero_nll_within_1e_5(run):
    res, _, want = run
    np.testing.assert_allclose(res.nll[0], want, rtol=1e-5, atol=0)


def test_reservoir_and_curator_equal_the_replay(run):
    res, lines, _ = run
    assert res.same
    assert "  device reservoir == host curator: True" in lines
    ids, nll = np.concatenate(res.ids), np.concatenate(res.nll)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(ids[order], np.arange(160))
    trace = nll[order].astype(np.float64)
    stats = res.curator.stats
    assert stats.observed == 160
    for sim in (t_sim.simulate(trace, 16, t_place.Policy(r=80)),
                r_sim.simulate(trace, 16, r_place.Policy(r=80))):
        assert stats.writes == int(sim.writes_per_tier.sum())
        assert stats.evictions == sim.evictions
        np.testing.assert_array_equal(sorted(res.hard),
                                      np.sort(sim.survivor_ids))
    assert stats.writes == int(res.store.ledger.writes.sum())


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
