"""examples_torch/capacity_slo_cloud.py (host modules only) against
examples/capacity_slo_cloud.py at ``--sim-docs 5000 --trials 2``: standard
output equal, line for line (the same closed forms, brute-force grid and
seeded trace replays in float64)."""
import pytest

from example_scripts import (assert_import_guard, load, printed, ref_main,
                             start_import_guard)

SMALL = ["--sim-docs", "5000", "--trials", "2"]

port = load("examples_torch/capacity_slo_cloud.py", "port_capacity_slo_cloud")
ref = load("examples/capacity_slo_cloud.py", "ref_capacity_slo_cloud")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/capacity_slo_cloud.py",
                              "repro_torch.core.constraints")


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.n_docs, args.k, args.sim_docs, args.trials) == (
        int(1e7), int(1e5), 20_000, 3)
    assert not hasattr(args, "device")


def test_stdout_equals_the_reference(guard):
    _, got = printed(port.run, port.parse_args(SMALL))
    want = ref_main(ref, SMALL)
    assert got == want
    assert len(got) > 10


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
