"""examples_torch/online_replanning.py on the CPU (``--streams 4 --docs
4000 --drift-at 1000 --oracle-grid 3``) against
examples/online_replanning.py with the same flags: the re-plan events
(stream, position, old and new bounds, applied) equal; the static,
re-planned and oracle fleet costs within 1e-11 relative (each a sum of
float64 simulator replays over the same schedules); the constraint
report and the admission decision equal; every printed line equal, the
wall time aside."""
import dataclasses

import numpy as np
import pytest

from example_scripts import (assert_import_guard,
                             assert_no_card_stops, load, printed, ref_main,
                             start_import_guard, untimed)

SMALL = ["--streams", "4", "--docs", "4000", "--drift-at", "1000",
         "--oracle-grid", "3"]

port = load("examples_torch/online_replanning.py", "port_online_replanning")
ref = load("examples/online_replanning.py", "ref_online_replanning")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/online_replanning.py",
                              "repro_torch.online.evaluate")


@pytest.fixture(scope="module")
def both(guard):
    seen = {}
    evaluate, admission = ref.evaluate.evaluate_fleet, ref.AdmissionController

    def evaluating(*a, **kw):
        seen["ev"] = evaluate(*a, **kw)
        return seen["ev"]

    class Admitting(admission):
        def admit(self, *a, **kw):
            seen["dec"] = super().admit(*a, **kw)
            return seen["dec"]

    mp = pytest.MonkeyPatch()
    mp.setattr(ref.evaluate, "evaluate_fleet", evaluating)
    mp.setattr(ref, "AdmissionController", Admitting)
    try:
        want = ref_main(ref, SMALL)
    finally:
        mp.undo()
    res, got = printed(port.run, port.parse_args(SMALL + ["--device",
                                                          "cpu"]))
    return res, got, seen, want


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.streams, args.docs, args.k, args.drift_at,
            args.multiplier, args.chunk, args.alpha, args.oracle_grid,
            args.seed, args.device) == (8, 12000, 64, 3000, 8.0, 64, 0.05,
                                        10, 1, "cuda")



def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args(SMALL), tmp_path)


def test_replan_events_equal_the_reference(both):
    res, _, seen, _ = both
    key = lambda e: (e.stream_id, e.position, tuple(e.old_bounds),  # noqa
                     tuple(e.new_bounds), e.applied)
    want = [key(e) for e in seen["ev"].engine.replan_events]
    assert [key(e) for e in res.engine.replan_events] == want
    assert any(e[-1] for e in want)


def test_fleet_costs_within_1e_11(both):
    res, _, seen, _ = both
    for name in ("static_cost", "replanned_cost", "oracle_cost"):
        np.testing.assert_allclose(getattr(res.ev, name),
                                   getattr(seen["ev"], name), rtol=1e-11,
                                   atol=0)
    assert res.ev.fleet_replanned < res.ev.fleet_static


def test_constraints_and_admission_equal_the_reference(both):
    res, _, seen, _ = both
    want = seen["ev"].engine.check_constraints()
    assert set(res.report) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(res.report[key], value, err_msg=key)
    assert res.report["ok"]
    assert dataclasses.asdict(res.decision) == \
        dataclasses.asdict(seen["dec"])
    assert res.decision.admitted and res.decision.negotiated


def test_lines_equal_the_reference(both):
    _, got, _, want = both
    assert untimed(got) == untimed(want)
    assert got[-1] == "online re-planning demo OK"


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
