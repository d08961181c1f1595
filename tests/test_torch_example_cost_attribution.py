"""examples_torch/cost_attribution.py on the CPU at its defaults against
examples/cost_attribution.py: the cost and burn alerts and the re-plan
decisions (events in order, their attributes, timestamps aside), the
regret table and every printed line, the OK line among them, equal."""
import numpy as np
import pytest

from example_scripts import (assert_import_guard,
                             assert_no_card_stops, load, printed, ref_main,
                             start_import_guard)

port = load("examples_torch/cost_attribution.py", "port_cost_attribution")
ref = load("examples/cost_attribution.py", "ref_cost_attribution")
KINDS = ("cost_alert", "budget_burn", "replan_decision")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/cost_attribution.py",
                              "repro_torch.obs")


@pytest.fixture(scope="module")
def both(guard):
    seen = {}
    obs_cls = ref.Observability

    def observing(*a, **kw):
        seen["obs"] = obs_cls(*a, **kw)
        return seen["obs"]

    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "Observability", observing)
    try:
        want = ref_main(ref, [])
    finally:
        mp.undo()
    res, got = printed(port.run, port.parse_args(["--device", "cpu"]))
    return res, got, seen["obs"], want


def _events(obs):
    return [(e["name"], e["attrs"]) for e in obs.tracer.events
            if e["name"] in KINDS]


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.streams, args.docs, args.k, args.drift_at,
            args.multiplier, args.chunk, args.seed, args.oracle_grid,
            args.out, args.device) == (4, 12000, 64, 3000, 8.0, 64, 7, 6,
                                       None, "cuda")



def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args(
        ["--out", str(tmp_path / "obs")]), tmp_path)


def test_alerts_and_replans_equal_the_reference(both):
    res, _, obs, _ = both
    got, want = _events(res.obs), _events(obs)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert set(a) == set(b), name
        for key in a:
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{name}.{key}")
    assert res.cost_replans
    assert any(n == "budget_burn" for n, _ in got)


def test_regret_table_and_lines_equal_the_reference(both):
    res, got, _, want = both
    assert got == want
    assert got[-1] == ("OK: budget burn alert → cost-triggered re-plan → "
                       "flattened realized-cost curve")
    assert not res.failures


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
