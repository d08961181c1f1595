"""examples_torch/million_streams.py on the CPU at a small size (2,000
streams of 64 docs in chunks of 16, 4 logmem tenants at K = 256 in
chunks of 512), unsharded and on a FleetMesh of 2 shards, against
examples/million_streams.py's parts. The reference's ``main`` plans
through ``shp_jax``, whose device solver is unavailable under jax 0.9,
so its parts are held one by one:

* ``fleet_cost_arrays`` bit-equal from the same generator;
* the plan and the binding streams' re-solve against the reference's
  NumPy oracle, ``repro.core.shp.plan_ntier_arrays_numpy``, on the same
  arrays: bounds, migrate flags and totals equal (on the CPU the port's
  "auto" planner is its NumPy solver, so they are equal bit for bit,
  inside the limits the card's device plan is held to);
* the ingest against the reference's own ``StreamEngine`` (unsharded),
  built from the port's boundaries and migrate flags, over the
  reference's ``dense_chunks`` from the same generator state: survivors,
  the obs counters and the logmem admits equal.

The sharded run must equal the unsharded one bit for bit, its timings
and its shard count aside.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from example_scripts import (assert_import_guard,
                             assert_no_card_stops, load,
                             start_import_guard)
from repro.core import shp as r_shp

SMALL = ["--streams", "2000", "--docs", "64", "--chunk", "16",
         "--logmem-streams", "4", "--logmem-k", "256", "--logmem-chunk",
         "512"]
TIMINGS = ("engine_build_s", "ingest_s", "ingest_docs_per_s", "finalize_s")
PLAN_TIMINGS = ("solve_s", "waterfill_s", "resolve_s")

port = load("examples_torch/million_streams.py", "port_million_streams")


def _load_reference():
    """The reference script writes XLA_FLAGS (a forced host device count)
    when it is imported: import it under a neutral argv and put the
    variable back, so that no later subprocess inherits the count."""
    saved_argv, saved = sys.argv, os.environ.get("XLA_FLAGS")
    sys.argv = ["million_streams.py", "--devices", "1"]
    try:
        return load("examples/million_streams.py", "ref_million_streams")
    finally:
        sys.argv = saved_argv
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


ref = _load_reference()


def _run(tmp_path, devices):
    args = port.parse_args(SMALL + ["--device", "cpu", "--devices",
                                    str(devices), "--out",
                                    str(tmp_path / f"ms{devices}.json")])
    return args, port.run(args)


@pytest.fixture(scope="module")
def guard():
    return start_import_guard("examples_torch/million_streams.py",
                              "repro_torch.streams.engine")


@pytest.fixture(scope="module")
def runs(guard, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("million_streams")
    return {d: _run(tmp, d) for d in (1, 2)}


def test_flags_and_defaults():
    args = port.parse_args([])
    assert (args.devices, args.streams, args.docs, args.chunk, args.topk,
            args.hot_frac, args.meter, args.logmem_streams, args.logmem_k,
            args.logmem_chunk, args.ci, args.out, args.device) == (
        8, 1_000_000, 256, 16, 8, 0.6, False, None, 65_536, 8_192, False,
        "bench_out/million_streams.json", "cuda")


def test_reference_import_leaves_xla_flags_alone():
    assert "xla_force_host_platform_device_count=1" not in \
        os.environ.get("XLA_FLAGS", "")



def test_no_card_stops_before_writing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert_no_card_stops(port.run, port.parse_args(SMALL), tmp_path)


def test_cost_arrays_equal_the_reference():
    got = port.fleet_cost_arrays(np.random.default_rng(3), 500, 64, 8)
    want = ref.fleet_cost_arrays(np.random.default_rng(3), 500, 64, 8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_plan_and_resolve_equal_the_numpy_oracle(runs):
    _, res = runs[1]
    plan = res.plan
    oracle = r_shp.plan_ntier_arrays_numpy(*plan["args"])
    for key in ("bounds", "migrate", "total"):
        np.testing.assert_array_equal(plan["solve"][key], oracle[key])
    idx = plan["idx"]
    assert idx.size == plan["stats"]["binding_streams"] > 0
    re = r_shp.plan_ntier_arrays_numpy(*(a[idx] for a in plan["args"]),
                                       cap=plan["cap"])
    for key in ("bounds", "migrate", "total"):
        np.testing.assert_array_equal(plan["resolve"][key], re[key])
    merged = oracle["bounds"].copy()
    merged[idx] = re["bounds"]
    np.testing.assert_array_equal(plan["bounds"], merged)
    assert plan["stats"]["hot_peak_docs"] <= \
        plan["stats"]["hot_budget_docs"] * (1 + 1e-9) + 1e-6


def test_ingest_equals_the_reference_engine(runs):
    args, res = runs[1]
    m, k, lm = args.streams, args.topk, 4
    lk, lw = args.logmem_k, args.logmem_chunk
    rng = np.random.default_rng(0)
    ref.fleet_cost_arrays(rng, m, args.docs, k)  # the plan's draws
    specs = [ref.StreamSpec(stream_id=i, k=k, boundaries=tuple(b),
                            migrate=bool(g))
             for i, (b, g) in enumerate(zip(res.plan["bounds"].tolist(),
                                            res.plan["migrate"].tolist()))]
    specs += [ref.StreamSpec(stream_id=m + i, k=lk, r=float(4 * lk),
                             engine="logmem") for i in range(lm)]
    eng = ref.StreamEngine(specs, obs=ref.Observability(
        ref.ObsConfig(residuals=False)))
    n_chunks = args.docs // args.chunk
    done = eng.ingest_chunks(
        ref.dense_chunks(rng, m, args.chunk, n_chunks, lm, lw), meter=False)
    assert done == res.done == n_chunks
    want = eng.survivors()
    got = res.engine.survivors()
    assert set(got) == set(want)
    for sid in want:
        np.testing.assert_array_equal(got[sid], want[sid])
    em = eng.obs_snapshot()["engine"]
    for key in ("docs", "admits", "evictions", "chunks"):
        assert res.snapshot["engine"][key] == em[key], key
    lb = [b.engine for b in eng.buckets].index("logmem")
    np.testing.assert_array_equal(
        res.engine.states()[lb].admits.numpy(),
        np.asarray(eng._states[lb].admits)[:lm])
    assert res.lm_stats["admits_mean"] == float(
        np.asarray(eng._states[lb].admits, np.float64)[:lm].mean())


def test_two_shards_equal_one(runs):
    (_, one), (_, two) = runs[1], runs[2]
    assert one.mesh is None and len(two.mesh.devices) == 2
    a, b = dict(one.out), dict(two.out)
    for out in (a, b):
        for key in TIMINGS:
            out.pop(key)
        out["plan"] = {key: v for key, v in out["plan"].items()
                       if key not in PLAN_TIMINGS}
    assert (a.pop("shards"), b.pop("shards")) == (1, 2)
    assert a == b
    for key in ("bounds", "migrate"):
        np.testing.assert_array_equal(one.plan[key], two.plan[key])
    s1, s2 = one.engine.survivors(), two.engine.survivors()
    for sid in s1:
        np.testing.assert_array_equal(s1[sid], s2[sid])
    for st1, st2 in zip(one.engine.states(), two.engine.states()):
        for x, y in zip(st1, st2):
            assert torch.equal(x, y)
    np.testing.assert_array_equal(one.engine.meter.reads,
                                  two.engine.meter.reads)


def test_json_written(runs):
    args, res = runs[2]
    with open(args.out) as f:
        assert json.load(f) == json.loads(json.dumps(res.out))
    assert res.out["shards"] == 2 and res.out["devices"] == 1
    assert res.out["logmem"]["memory_ratio"] >= 8.0


def test_imports_neither_jax_nor_the_reference(guard):
    assert_import_guard(guard)
