"""examples_torch/chaos_recovery.py on the CPU (``--tenants 4``): the
child process dies by SIGKILL, the recovered run's digest equals the
uninterrupted run's, and the drill ends with ``CHAOS-OK``. The port's
uninterrupted run is held to examples/chaos_recovery.py's own (its
``build_engine``, ``make_chunk`` and ``digest`` over the same chunks):
the same sha256, the survivors, and every leaf of the meter's and the
cost monitor's ``state_dict`` bit-equal, by name."""
import signal

import numpy as np
import pytest

from example_scripts import (assert_import_guard, assert_no_card_stops,
                             load, printed, start_import_guard)

SMALL = ["--tenants", "4"]

port = load("examples_torch/chaos_recovery.py", "port_chaos_recovery")
ref = load("examples/chaos_recovery.py", "ref_chaos_recovery")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/chaos_recovery.py",
                              "repro_torch.resilience")


@pytest.fixture(scope="module")
def drill(guard, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos")
    args = port.parse_args(SMALL + ["--device", "cpu", "--ckpt-dir",
                                    str(tmp / "ckpt"), "--out",
                                    str(tmp / "out")])
    res, lines = printed(port.run, args)
    eng = ref.build_engine(args.tenants, args.total_docs, args.k)
    for i in range(args.chunks):
        eng.ingest_dense(ref.make_chunk(eng, i, args.seed))
    return args, res, lines, eng, ref.digest(eng)


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.tenants, args.k, args.chunks, args.extra_chunks,
            args.seed, args.kill_at, args.ckpt_every, args.ckpt_dir,
            args.out, args.role, args.device) == (
        6, 8, 12, 6, 0, 7, 2, "chaos_ckpt", "chaos_out", "parent", "cuda")


def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args(SMALL), tmp_path)


def test_killed_restored_and_bitwise(drill):
    args, res, lines, _, _ = drill
    assert res.child_rc in (-signal.SIGKILL, 128 + signal.SIGKILL)
    assert res.cursor <= args.kill_at
    assert res.rec_digest == res.ref_digest
    assert lines[-1] == "CHAOS-OK"
    assert "phase 1 OK: crash/restore/resume is bitwise invisible" in lines
    assert res.resilience["tier_outages"] == 1


def test_uninterrupted_run_equals_the_reference(drill):
    _, res, _, eng, digest = drill
    assert res.ref_digest == digest
    want, got = eng.survivors(), res.ref.survivors()
    assert set(got) == set(want)
    for sid in want:
        np.testing.assert_array_equal(got[sid], want[sid])
    for mine, theirs in ((res.ref.meter, eng.meter),
                         (res.ref._cost_monitor, eng._cost_monitor)):
        a, b = mine.state_dict(), theirs.state_dict()
        assert sorted(a) == sorted(b)
        for name in b:
            x, y = np.asarray(a[name]), np.asarray(b[name])
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
