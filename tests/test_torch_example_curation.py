"""examples_torch/train_topk_curation.py on the CPU at the reference
example's smoke size (``--steps 20 --d-model 128 --layers 2 --seq 64
--batch 4``), against examples/train_topk_curation.py's own config and
cost model, and against core.simulator's replay of the stream its curator
saw (the port's and the reference's simulator). Both examples are loaded
from their files; only this test imports the reference's.

Every comparison is exact: the parameter count and the SHP plan are
integer and closed-form float64 arithmetic on the same inputs, and the
replay runs the same reservoir over the same scores.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import simulator as ref_simulator
from repro_torch.core import simulator as t_simulator
from repro_torch.optim.adamw import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--steps", "20", "--d-model", "128", "--layers", "2", "--seq",
         "64", "--batch", "4"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = _load("examples_torch/train_topk_curation.py",
             "port_train_topk_curation")
ref = _load("examples/train_topk_curation.py", "ref_train_topk_curation")


class Recording:
    """The curator the loop feeds, keeping the (ids, scores) it saw."""

    def __init__(self, curator):
        self.curator, self.ids, self.scores = curator, [], []

    def observe_batch(self, ids, scores, payloads):
        self.ids.append(np.array(ids))
        self.scores.append(np.array(scores, np.float64))
        return self.curator.observe_batch(ids, scores, payloads)


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("e2e_ckpt")
    args = port.parse_args(SMOKE + ["--ckpt-dir", str(ckpt), "--device",
                                    "cpu"])
    box = {}

    def wrap(curator):
        box["rec"] = Recording(curator)
        return box["rec"]

    return args, port.run(args, curator_wrapper=wrap), box["rec"]


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.steps, args.d_model, args.layers, args.vocab, args.seq,
            args.batch, args.reservoir_k, args.ckpt_dir, args.lr,
            args.device) == (300, 640, 10, 32768, 256, 8, 64,
                             "artifacts/e2e_ckpt", 3e-3, "cuda")


def test_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('e2e', sys.argv[1])\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.runtime.train_loop' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code,
         str(ROOT / "examples_torch" / "train_topk_curation.py")],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr


def test_no_card_fails_without_falling_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    args = port.parse_args(SMOKE + ["--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port.run(args)
    assert not any(tmp_path.iterdir())


def test_config_and_plan_equal_the_reference(first_run):
    args, res, _ = first_run
    assert port.param_count(res.cfg) == ref.param_count(ref.build_cfg(args))
    n_docs = args.steps * args.batch
    cm = ref.costs.hbm_host_preset(n_docs=n_docs, k=args.reservoir_k,
                                   doc_gb=args.seq * 4 / 1e9,
                                   window_seconds=3600.0)
    plan = ref.shp.plan_placement(cm)
    assert res.plan.strategy == plan.strategy
    assert res.plan.best.r_over_n == plan.best.r_over_n
    analytic = float(ref.shp.expected_cum_writes(n_docs - 1,
                                                 args.reservoir_k))
    assert res.curator.stats.observed == n_docs
    assert res.curator.expected_writes() == analytic


def test_curator_writes_equal_the_simulator_replay(first_run):
    args, res, rec = first_run
    assert res.report.steps_run == args.steps
    assert res.report.resumed_from is None
    ids, scores = np.concatenate(rec.ids), np.concatenate(rec.scores)
    order = np.argsort(ids, kind="stable")
    n_docs = args.steps * args.batch
    np.testing.assert_array_equal(ids[order], np.arange(n_docs))
    trace = scores[order]
    stats = res.curator.stats
    assert stats.writes == int(res.store.ledger.writes.sum())
    ref_pol = ref.placement.from_plan(ref.shp.plan_placement(
        ref.costs.hbm_host_preset(n_docs=n_docs, k=args.reservoir_k,
                                  doc_gb=args.seq * 4 / 1e9,
                                  window_seconds=3600.0)))
    for sim in (t_simulator.simulate(trace, args.reservoir_k, res.policy),
                ref_simulator.simulate(trace, args.reservoir_k, ref_pol)):
        assert stats.writes == int(sim.writes_per_tier.sum())
        assert stats.evictions == sim.evictions
        np.testing.assert_array_equal(res.curator.survivor_ids(),
                                      np.sort(sim.survivor_ids))
    assert sorted(res.hardest) == list(res.curator.survivor_ids())


def test_second_run_resumes_from_the_last_checkpoint(first_run):
    args, res, _ = first_run
    again = port.run(args)
    assert again.report.resumed_from == args.steps
    assert again.report.steps_run == 0
    leaves = [tree_leaves(r.report.final_state.params) for r in (res, again)]
    assert len(leaves[0]) == len(leaves[1])
    for a, b in zip(*leaves):
        assert torch.equal(a, b)
