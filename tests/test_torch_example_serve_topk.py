"""examples_torch/serve_topk.py on the CPU (``--requests 16 --batch 4
--prompt-len 16 --gen-len 12``, one tenant and four) against the port's
launcher, ``repro_torch.launch.serve.main``, with the same flags: the
retained requests and the ledger lines equal (every line from the
throughput line on, the throughput aside). tests/test_torch_serve.py
holds the launcher's loop to examples/serve_topk.py's."""
import pytest

from example_scripts import (assert_import_guard, assert_no_card_stops,
                             load, printed, start_import_guard, untimed)
from repro_torch.launch import serve as t_serve

SMALL = ["--requests", "16", "--batch", "4", "--prompt-len", "16",
         "--gen-len", "12"]

port = load("examples_torch/serve_topk.py", "port_serve_topk")


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/serve_topk.py",
                              "repro_torch.launch.serve")


def _after_served(lines):
    at = next(i for i, line in enumerate(lines)
              if line.startswith("served "))
    return untimed(lines[at:])


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.arch, args.requests, args.batch, args.prompt_len,
            args.gen_len, args.topk, args.tenants, args.obs_out,
            args.obs_port, args.obs_hold, args.mesh, args.ckpt_dir,
            args.ckpt_every, args.device) == (
        "llama3.2-1b", 64, 8, 16, 12, 8, 1, None, None, 0.0, 1, None, 4,
        "cuda")


def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args(SMALL), tmp_path)


@pytest.mark.parametrize("tenants", [1, 4])
def test_retained_and_ledgers_equal_the_launcher(guard, tenants):
    argv = SMALL + ["--tenants", str(tenants), "--device", "cpu"]
    res, got = printed(port.run, port.parse_args(argv))
    _, want = printed(t_serve.main, argv)
    assert got[0] == "serving reduced llama3.2-1b: vocab=256"
    if tenants == 1:
        assert got[1].startswith("SHP plan for request log: ")
        assert sorted(res.res.retained) == sorted(
            int(i) for i in got[-1].split(": ")[1].strip("[]").split(", "))
    else:
        assert got[1].startswith("multi-tenant retention: 4 streams, ")
        assert sorted(res.res.retained) == [0, 1, 2, 3]
    assert _after_served(got) == _after_served(want)
    assert len(_after_served(got)) == (4 if tenants == 1 else 7)


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
