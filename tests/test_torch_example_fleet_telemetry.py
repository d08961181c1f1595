"""examples_torch/fleet_telemetry.py on the CPU (``--streams 3 --docs
4000 --drift-at 1000``) against examples/fleet_telemetry.py's
``run_once`` on the same fleet and traces (the reference's ``main``
ends in its jit-probe check, which fails under jax 0.9, where no probe
registers): the race table (residual alerts and CUSUM detections), the
write-law residual snapshot, the device counters and the regret table
equal; the three obs artifacts written; and, off the card, the line
that says the compile-cache check is skipped."""
import os
from types import SimpleNamespace

import numpy as np
import pytest

from example_scripts import (assert_import_guard,
                             assert_no_card_stops, load, printed,
                             start_import_guard)

SMALL = ["--streams", "3", "--docs", "4000", "--drift-at", "1000"]

port = load("examples_torch/fleet_telemetry.py", "port_fleet_telemetry")
ref = load("examples/fleet_telemetry.py", "ref_fleet_telemetry")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/fleet_telemetry.py",
                              "repro_torch.obs.jits")


@pytest.fixture(scope="module")
def both(guard, tmp_path_factory):
    out = tmp_path_factory.mktemp("obs_out")
    args = port.parse_args(SMALL + ["--device", "cpu", "--out", str(out)])
    res, lines = printed(port.run, args)
    rng = np.random.default_rng(args.seed)
    specs = ref.make_fleet(args.streams, args.docs, args.k)
    traces = np.stack([
        ref.simulator.drifted_rank_trace(args.docs, rng,
                                         [(args.drift_at, args.multiplier)])
        for _ in range(args.streams)])
    np.testing.assert_array_equal(traces, res.traces)
    engine = ref.run_once(traces, specs, SimpleNamespace(**vars(args)),
                          ref.Observability(ref.ObsConfig(
                              residual_alpha=args.alpha, costs=True)))
    return args, res, lines, engine


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.streams, args.docs, args.k, args.drift_at,
            args.multiplier, args.chunk, args.alpha, args.seed, args.out,
            args.device) == (6, 12000, 64, 3000, 8.0, 64, 0.05, 5,
                             "obs_out", "cuda")



def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args(
        SMALL + ["--out", str(tmp_path / "obs")]), tmp_path)


def test_race_equals_the_reference(both):
    _, res, _, engine = both
    assert res.alerts == engine.residual_alerts()
    detected = {}
    for ev in engine.replan_events:
        detected.setdefault(ev.stream_id, ev.position)
    assert res.detected == detected
    assert len(detected) == 3
    assert all(res.alerts[s] <= d for s, d in detected.items())


def test_residuals_and_counters_equal_the_reference(both):
    _, res, _, engine = both
    snap = engine.obs_snapshot()
    assert res.snapshot["residuals"]["writes"] == snap["residuals"]["writes"]
    for key in ("docs", "admits", "evictions", "filter_pass_rate",
                "chunks"):
        assert res.snapshot["engine"][key] == snap["engine"][key], key


def test_regret_table_equals_the_reference(both):
    _, res, _, engine = both
    want = ref.evaluate.regret_table(engine)
    assert len(res.regret) == len(want)
    for a, b in zip(res.regret, want):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert port.evaluate.format_regret_table(res.regret) == \
        ref.evaluate.format_regret_table(want)


def test_artifacts_and_the_cpu_line(both):
    args, res, lines, _ = both
    assert sorted(os.path.basename(p) for p in res.paths.values()) == \
        ["events.jsonl", "metrics.json", "metrics.prom"]
    assert all(os.path.getsize(p) > 0 for p in res.paths.values())
    assert ("jit probe kernels.build: not checked on cpu (no kernel is "
            "built off the card)") in lines
    assert lines[-1] == "fleet telemetry demo OK"
    assert not res.failures


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
