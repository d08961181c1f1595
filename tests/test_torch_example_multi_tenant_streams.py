"""examples_torch/multi_tenant_streams.py on the CPU (``--streams 64
--docs 128``) against examples/multi_tenant_streams.py with the same
flags: every printed line equal, wall times and rates aside, and every
stream's survivors equal to the reference engine's."""
import numpy as np
import pytest

from example_scripts import (assert_import_guard,
                             assert_no_card_stops, load, printed, ref_main,
                             start_import_guard, untimed)

SMALL = ["--streams", "64", "--docs", "128"]

port = load("examples_torch/multi_tenant_streams.py", "port_multi_tenant")
ref = load("examples/multi_tenant_streams.py", "ref_multi_tenant")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/multi_tenant_streams.py",
                              "repro_torch.streams.engine")


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.streams, args.docs, args.batch, args.seed,
            args.kernel_filter, args.device) == (1024, 256, 32, 0, False,
                                                 "cuda")
    assert port.parse_args(["--kernel-filter"]).kernel_filter



def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args(SMALL), tmp_path)


def test_lines_and_survivors_equal_the_reference(guard, monkeypatch):
    engines = []
    real = ref.StreamEngine

    def recording(*a, **kw):
        engines.append(real(*a, **kw))
        return engines[-1]

    monkeypatch.setattr(ref, "StreamEngine", recording)
    want = ref_main(ref, SMALL)
    res, got = printed(port.run, port.parse_args(SMALL + ["--device",
                                                          "cpu"]))
    assert untimed(got) == untimed(want)
    assert len(got) == 6 and "bit-match 64/64" in got[2]
    assert res.matched == 64
    survivors = engines[0].survivors()
    assert set(res.survivors) == set(survivors) == set(range(64))
    for sid, ids in survivors.items():
        np.testing.assert_array_equal(res.survivors[sid], ids)


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
