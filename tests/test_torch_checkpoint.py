"""repro_torch.checkpoint against the JAX package's repro.checkpoint, on
the cases of tests/test_checkpoint.py: atomic roundtrip, retention,
tiering, async saves, format v2 (checksums, generation lineage, manifest
extra) and torn saves — the port's ``CheckpointManager`` on trees of
torch tensors.

Two cases the reference's tests cannot show: a port tree and its
reference twin (jnp leaves, the same structure) write the same
``n_leaves``, the same leaf files and the same checksums — the port's
``tree_flatten`` numbers leaves in ``jax.tree_util``'s order — and an
async save of a CPU engine's snapshot restores the values from before an
in-place update the engine made while the write was still queued.

Tolerance: exact (leaf bytes and checksums).
"""
import json
import os
import threading
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.checkpoint import manager as t_manager
from repro_torch.core.placement import Policy


def make_state(x: float):
    return {"w": torch.full((4, 3), x), "opt": {"m": torch.full((2,), x * 2)},
            "step": torch.tensor(int(x), dtype=torch.int32)}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state(3.0)
    mgr.save(state, step=3, metric=0.5, blocking=True)
    restored = mgr.restore(make_state(0.0))
    for key in ("w", "step"):
        assert torch.equal(restored[key], state[key])
        assert restored[key].dtype == state[key].dtype
    assert torch.equal(restored["opt"]["m"], state["opt"]["m"])


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(make_state(1.0), step=1, metric=1.0)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_latest_and_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_latest=10)
    for s in (1, 2, 3):
        mgr.save(make_state(float(s)), step=s, metric=float(s), blocking=True)
    assert mgr.latest_step() == 3
    st = mgr.restore(make_state(0.0), step=2)
    assert float(st["w"][0, 0]) == 2.0
    with pytest.raises(FileNotFoundError):
        mgr.restore(make_state(0.0), step=7)


def test_retention_keeps_latest_and_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_latest=1, keep_best=2,
                            metric_mode="min")
    metrics = {1: 5.0, 2: 0.1, 3: 4.0, 4: 0.2, 5: 9.0}
    for s, m in metrics.items():
        mgr.save(make_state(float(s)), step=s, metric=m, blocking=True)
    steps = {m["step"] for m, _ in mgr._all_ckpts()}
    assert 5 in steps  # latest
    assert 2 in steps and 4 in steps  # two best by metric
    assert 1 not in steps and 3 not in steps


def test_tier_placement_by_policy(tmp_path):
    hot = tmp_path / "hot"
    cold = tmp_path / "cold"
    # first 2 saves to tier A (hot), the rest to tier B (cold)
    mgr = CheckpointManager(str(hot), cold_directory=str(cold),
                            keep_latest=10, policy=Policy(r=2))
    for s in range(4):
        mgr.save(make_state(float(s)), step=s, metric=1.0, blocking=True)
    hot_names = {d for d in os.listdir(hot) if d.startswith("ckpt_")}
    cold_names = {d for d in os.listdir(cold) if d.startswith("ckpt_")}
    assert len(hot_names) == 2 and len(cold_names) == 2


def test_torn_save_is_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(make_state(1.0), step=1, metric=1.0, blocking=True)
    # simulate a torn save: directory without manifest
    os.makedirs(tmp_path / "ckpt_00000009")
    assert mgr.latest_step() == 1


def test_corrupt_leaf_detected(tmp_path):
    """Restore verifies every leaf against its manifest sha256: a flipped
    byte raises instead of silently resuming from garbage."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(make_state(2.0), step=2, blocking=True)
    leaf = tmp_path / "ckpt_00000002" / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(make_state(0.0))
    # verify=False is the explicit escape hatch (forensics)
    mgr.restore(make_state(0.0), verify=False)


def test_generation_monotone_across_restarts(tmp_path):
    """The generation counter resumes from disk, so lineage stays totally
    ordered across crash/restore cycles even when steps repeat."""
    mgr = CheckpointManager(str(tmp_path), keep_latest=10)
    g1 = mgr.save(make_state(1.0), step=1, blocking=True)
    g2 = mgr.save(make_state(2.0), step=2, blocking=True)
    assert g2 > g1
    mgr2 = CheckpointManager(str(tmp_path), keep_latest=10)  # "restart"
    assert mgr2.generation() == g2
    g3 = mgr2.save(make_state(9.0), step=2, blocking=True)  # re-save step
    assert g3 > g2
    assert mgr2.manifest(2)["generation"] == g3


def test_manifest_extra_roundtrip(tmp_path):
    """Variable-length host state rides the manifest's ``extra`` and
    comes back JSON-identical."""
    mgr = CheckpointManager(str(tmp_path))
    extra = {"events": [{"row": 1, "bounds": [4.0, 9.0]}],
             "failed_tiers": {"1": 3}}
    mgr.save(make_state(1.0), step=1, blocking=True, extra=extra)
    assert mgr.manifest()["extra"] == json.loads(json.dumps(extra))
    assert mgr.manifest(1)["extra"]["failed_tiers"] == {"1": 3}


def test_torn_async_save_keeps_previous(tmp_path):
    """A .tmp directory left by a torn async write is never listed as a
    checkpoint; the previous committed one still restores."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(make_state(1.0), step=1, blocking=True)
    os.makedirs(tmp_path / "ckpt_00000005.tmp")
    (tmp_path / "ckpt_00000005.tmp" / "leaf_00000.npy").write_bytes(b"torn")
    assert mgr.latest_step() == 1
    st = mgr.restore(make_state(0.0))
    assert float(st["w"][0, 0]) == 1.0


def test_restore_refuses_another_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(make_state(1.0), step=1, blocking=True)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": torch.zeros(4, 3)})


# ---------------------------------------------------------------------------
# the reference's leaf order: a port tree and its reference twin
# ---------------------------------------------------------------------------

class Pair(NamedTuple):
    zeta: object
    alpha: object


def twin_trees(kind):
    """(port tree of torch tensors, reference twin of jnp arrays): dicts
    built in unsorted key order, NamedTuples whose fields are not in
    alphabetical order, tuples and lists, ``None`` nodes and scalar
    leaves."""
    rng = np.random.default_rng(len(kind))
    a = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.integers(-9, 9, (7,)).astype(np.int32)
    c = rng.random(4) < 0.5
    if kind == "state":
        return make_state(3.0), {
            "w": jnp.full((4, 3), 3.0), "opt": {"m": jnp.full((2,), 6.0)},
            "step": jnp.asarray(3, jnp.int32)}

    def tree(arr):
        return {"zz": Pair(arr(a), [arr(b), None, (arr(c),)]),
                "aa": None, "mm": {"y": arr(b), "b": (arr(a), arr(c))},
                "cursor": np.int64(12), "score": np.float32(0.25),
                "n": 7, "x": 1.5}

    if kind == "nested":
        return tree(torch.tensor), tree(jnp.asarray)
    # numpy leaves on both sides (the fleet snapshot's kind of tree)
    return tree(np.array), tree(np.array)


@pytest.mark.parametrize("kind", ["state", "nested", "numpy"])
def test_twin_trees_write_the_same_checkpoint(tmp_path, kind):
    ttree, jtree = twin_trees(kind)
    tm = CheckpointManager(str(tmp_path / "t"))
    jm = JCheckpointManager(str(tmp_path / "j"))
    tm.save(ttree, step=4, blocking=True)
    jm.save(jtree, step=4, blocking=True)
    tman, jman = tm.manifest(), jm.manifest()
    assert tman["n_leaves"] == jman["n_leaves"]
    assert tman["checksums"] == jman["checksums"]
    for i in range(tman["n_leaves"]):
        name = f"ckpt_00000004/leaf_{i:05d}.npy"
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    # and each restores the other's directory
    back = CheckpointManager(str(tmp_path / "j")).restore(ttree)
    leaves, treedef = t_manager.tree_flatten(ttree)
    back_leaves, back_def = t_manager.tree_flatten(back)
    assert back_def == treedef
    for x, y in zip(leaves, back_leaves):
        if isinstance(x, torch.Tensor):  # tensors come back as tensors
            assert isinstance(y, torch.Tensor) and y.dtype == x.dtype
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_tree_flatten_roundtrip():
    ttree, _ = twin_trees("nested")
    leaves, treedef = t_manager.tree_flatten(ttree)
    back = t_manager.tree_unflatten(treedef, leaves)
    assert isinstance(back["zz"], Pair) and back["aa"] is None
    assert back["zz"].alpha[1] is None
    assert isinstance(back["zz"].alpha[2], tuple)
    assert t_manager.tree_flatten(back)[1] == treedef
    assert all(x is y for x, y in zip(leaves,
                                      t_manager.tree_flatten(back)[0]))


# ---------------------------------------------------------------------------
# aliasing: an async save holds host copies, never the engine's memory
# ---------------------------------------------------------------------------

def test_async_save_of_cpu_engine_is_not_aliased(tmp_path):
    """On the CPU a tensor's ``.numpy()`` shares its memory: the snapshot
    must copy. The write is held behind a gate until the engine's state
    was updated in place; the checkpoint restores the values from
    before the update."""
    from repro_torch.resilience import FleetCheckpointer
    from repro_torch.streams import StreamEngine, StreamSpec
    specs = [StreamSpec(stream_id=i, k=4, boundaries=(8.0, 32.0))
             for i in range(3)]
    eng = StreamEngine(specs, device="cpu")
    rng = np.random.default_rng(0)
    for c in range(3):
        eng.ingest_dense([(rng.random((3, 4)).astype(np.float32),
                           np.tile(np.arange(c * 4, c * 4 + 4,
                                             dtype=np.int32), (3, 1)))])
    before = [t.clone() for t in eng._states[0]]
    ck = FleetCheckpointer(str(tmp_path), every=0)
    gate = threading.Event()
    ck.manager._pool.submit(gate.wait, 30)  # the worker waits on the gate
    ck.save(eng)  # copies now, writes behind the gate
    scores, ids, seen = eng._states[0]
    scores.add_(100.0)
    ids.fill_(7)
    seen.zero_()
    gate.set()
    ck.wait()
    fresh = StreamEngine(specs, device="cpu")
    ck.restore(fresh)
    for a, b in zip(before, fresh._states[0]):
        assert torch.equal(a, b)
