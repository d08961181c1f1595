"""Fault-tolerant checkpointing with SHP-tiered retention — the port of the
reference's ``checkpoint.manager``.

* Atomic: leaves as .npy + manifest.json written to a temp dir, renamed on
  completion — a crash mid-save never corrupts the latest checkpoint.
* Async: saves run on a worker thread from host copies (each tensor leaf
  is copied to the host first), so the caller blocks only for the
  device→host transfer.
* Retention = the paper's workflow: checkpoints are a scored stream
  (validation metric = interestingness), we keep the top-K plus the most
  recent L; tier placement (hot/local vs cold/remote directory) follows the
  SHP policy over checkpoint index.
* Crash-consistent (format v2): every leaf carries a sha256 checksum in
  the manifest, verified on restore, and every save stamps a monotone
  *generation* counter that survives restarts — a resumed run keeps
  incrementing where the killed run stopped, so checkpoint lineage is
  totally ordered even across crash/restore cycles.

The leaves of a tree are numbered in the reference's order (``tree_flatten``
below), so ``n_leaves`` and ``leaf_i.npy`` mean the same thing in both
packages and a checkpoint directory written by one restores through the
other.
"""
from __future__ import annotations

import hashlib
import heapq
import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.placement import TIER_A, Policy

FORMAT_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A stored leaf fails its manifest checksum."""


# ---- the reference's leaf order --------------------------------------------
#
# The reference numbers leaves by ``jax.tree_util.tree_flatten``: dict keys
# sorted, tuples, lists and NamedTuples in field order, ``None`` a node with
# no leaf, anything else (arrays, tensors, scalars) one leaf.
# ``torch.utils._pytree`` keeps dict insertion order, so the port keeps its
# own flatten with the reference's order.

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in the reference's leaf order."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _walk(node, leaves: List[Any]):
    # module-level, not a closure: a self-referencing closure would hold
    # ``leaves`` in a reference cycle, keeping the tensors alive until the
    # cyclic collector runs (a whole parameter tree a training step)
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if _is_namedtuple(node):
        return ("namedtuple", type(node), [_walk(c, leaves) for c in node])
    if isinstance(node, (tuple, list)):
        return (type(node).__name__, None, [_walk(c, leaves) for c in node])
    leaves.append(node)
    return ("leaf",)


def tree_unflatten(treedef, leaves) -> Any:
    """Inverse of ``tree_flatten``."""
    return _build(treedef, iter(leaves))


def _build(node, it):
    kind = node[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    children = [_build(c, it) for c in node[2]]
    if kind == "dict":
        return dict(zip(node[1], children))
    if kind == "namedtuple":
        return node[1](*children)
    return tuple(children) if kind == "tuple" else children


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A fresh host array of a tensor, copied off its device — a CPU
    tensor too: ``.numpy()`` alone would share its memory."""
    return t.detach().to("cpu", copy=True).numpy()


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, *, cold_directory: Optional[str] = None,
                 keep_latest: int = 2, keep_best: int = 3,
                 policy: Optional[Policy] = None, metric_mode: str = "min"):
        self.dir = directory
        self.cold_dir = cold_directory or os.path.join(directory, "cold")
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(self.cold_dir, exist_ok=True)
        self.keep_latest = keep_latest
        self.keep_best = keep_best
        self.policy = policy
        self.metric_mode = metric_mode
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._save_index = 0
        # seconds the last save's npy writes + sha256 took (worker thread)
        self.last_write_s = 0.0
        # resume the generation lineage of whatever already lives on disk
        ckpts = self._all_ckpts()
        self._generation = max(
            (m.get("generation", 0) for m, _ in ckpts), default=0)

    # ---------------- paths ----------------
    def _name(self, step: int) -> str:
        return f"ckpt_{step:08d}"

    def _tier_dir(self, save_index: int) -> str:
        if self.policy is None:
            return self.dir
        return self.dir if self.policy.tier_of(save_index) == TIER_A \
            else self.cold_dir

    def _all_ckpts(self):
        out = []
        for root in {self.dir, self.cold_dir}:
            if not os.path.isdir(root):
                continue
            for d in os.listdir(root):
                p = os.path.join(root, d)
                mf = os.path.join(p, "manifest.json")
                if d.startswith("ckpt_") and os.path.exists(mf):
                    try:
                        with open(mf) as f:
                            out.append((json.load(f), p))
                    except (OSError, ValueError):
                        continue
        return sorted(out, key=lambda t: t[0]["step"])

    # ---------------- save ----------------
    def save(self, state: Any, step: int, metric: float = float("nan"),
             blocking: bool = False,
             extra: Optional[Dict[str, Any]] = None) -> int:
        """Snapshot ``state`` at ``step``; returns the generation stamped
        on the checkpoint. ``extra`` (JSON-able dict) rides in the
        manifest — host-side scalars/events that are not tree leaves.
        Non-blocking saves copy to host here and write on the worker
        thread, so compute on the next chunk overlaps the I/O."""
        self.wait()
        leaves, _ = tree_flatten(state)
        # tensors are copied off their device (a CPU tensor too); host
        # arrays are written as given, as the reference writes them
        host_leaves = [host_copy(leaf) if isinstance(leaf, torch.Tensor)
                       else np.asarray(leaf) for leaf in leaves]
        idx = self._save_index
        self._save_index += 1
        self._generation += 1
        gen = self._generation

        def _write():
            t1 = time.perf_counter()
            target_root = self._tier_dir(idx)
            final = os.path.join(target_root, self._name(step))
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            checksums = []
            for i, leaf in enumerate(host_leaves):
                p = os.path.join(tmp, f"leaf_{i:05d}.npy")
                np.save(p, leaf)
                checksums.append(_file_sha256(p))
            manifest = {"format": FORMAT_VERSION, "step": step,
                        "metric": float(metric),
                        "n_leaves": len(host_leaves), "save_index": idx,
                        "generation": gen, "checksums": checksums,
                        "time": time.time()}
            if extra is not None:
                manifest["extra"] = extra
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()
            self.last_write_s = time.perf_counter() - t1

        if blocking:
            _write()
        else:
            self._pending = self._pool.submit(_write)
        return gen

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # ---------------- retention ----------------
    def _retain(self):
        ckpts = self._all_ckpts()
        if not ckpts:
            return
        latest = {m["step"] for m, _ in ckpts[-self.keep_latest:]}
        sign = 1.0 if self.metric_mode == "max" else -1.0
        scored = [(sign * m.get("metric", float("nan")), m["step"])
                  for m, _ in ckpts if np.isfinite(m.get("metric", np.nan))]
        best = {s for _, s in heapq.nlargest(self.keep_best, scored)}
        for m, path in ckpts:
            if m["step"] not in latest and m["step"] not in best:
                shutil.rmtree(path, ignore_errors=True)

    # ---------------- restore ----------------
    def latest_step(self) -> Optional[int]:
        ckpts = self._all_ckpts()
        return ckpts[-1][0]["step"] if ckpts else None

    def generation(self) -> int:
        """Generation stamped on the most recent save (0 = none yet)."""
        return self._generation

    def _lookup(self, step: Optional[int]):
        ckpts = self._all_ckpts()
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        if step is None:
            return ckpts[-1]
        match = [(m, p) for m, p in ckpts if m["step"] == step]
        if not match:
            raise FileNotFoundError(f"no checkpoint for step {step}")
        return match[0]

    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The manifest dict of a stored checkpoint (latest by default)."""
        return self._lookup(step)[0]

    def restore(self, template: Any, step: Optional[int] = None,
                verify: bool = True) -> Any:
        """Load a checkpoint (latest by default) into ``template``'s
        structure. A leaf comes back as a numpy array in the template
        leaf's dtype, or as a tensor on the template tensor's device."""
        manifest, path = self._lookup(step)
        leaves, treedef = tree_flatten(template)
        if manifest.get("n_leaves") != len(leaves):
            raise ValueError(
                f"checkpoint at {path} has {manifest.get('n_leaves')} "
                f"leaves; template has {len(leaves)}")
        checksums = manifest.get("checksums")
        loaded = []
        for i, ref in enumerate(leaves):
            p = os.path.join(path, f"leaf_{i:05d}.npy")
            if verify and checksums is not None:
                digest = _file_sha256(p)
                if digest != checksums[i]:
                    raise CheckpointCorruptError(
                        f"leaf {i} of {path}: sha256 {digest[:12]}… != "
                        f"manifest {checksums[i][:12]}…")
            arr = np.load(p)
            if isinstance(ref, torch.Tensor):
                loaded.append(torch.from_numpy(arr).to(ref.device, ref.dtype))
                continue
            if hasattr(ref, "dtype") and arr.dtype != ref.dtype:
                arr = arr.astype(ref.dtype)
            loaded.append(arr)
        return tree_unflatten(treedef, loaded)
