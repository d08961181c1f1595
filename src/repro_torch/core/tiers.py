"""TieredStore — the runtime that holds top-K payloads across an ordered
tier hierarchy (hot device memory → host DRAM → disk/object store),
placing each write according to a ``placement.Policy`` (the paper's Fig. 3
loop, §VII, generalized to N tiers): the port of the reference's
``core.tiers``.

The ledger records every transaction and byte so real runs can be
reconciled against the analytic expectations (and against
``core.simulator``). For a fleet of tenant streams,
``streams.metering.FleetMeter`` keeps one ledger row per stream.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import device as device_mod

from .placement import Policy


@dataclass
class Ledger:
    """Per-tier transaction counters; index = tier (2 tiers by default)."""

    writes: np.ndarray = field(default_factory=lambda: np.zeros(2, np.int64))
    reads: np.ndarray = field(default_factory=lambda: np.zeros(2, np.int64))
    deletes: np.ndarray = field(default_factory=lambda: np.zeros(2, np.int64))
    migrations: int = 0
    bytes_written: np.ndarray = field(default_factory=lambda: np.zeros(2, np.int64))
    bytes_read: np.ndarray = field(default_factory=lambda: np.zeros(2, np.int64))

    @classmethod
    def sized(cls, n_tiers: int) -> "Ledger":
        z = lambda: np.zeros(n_tiers, np.int64)
        return cls(writes=z(), reads=z(), deletes=z(),
                   bytes_written=z(), bytes_read=z())

    @property
    def n_tiers(self) -> int:
        return self.writes.shape[0]

    def as_dict(self) -> dict:
        return {
            "writes": self.writes.tolist(), "reads": self.reads.tolist(),
            "deletes": self.deletes.tolist(), "migrations": self.migrations,
            "bytes_written": self.bytes_written.tolist(),
            "bytes_read": self.bytes_read.tolist(),
        }


class HotTier:
    """Device-resident slab: K preallocated slots of a fixed payload shape.
    Slot bookkeeping is host-side; payload bytes stay on ``device`` (the
    CUDA card unless given). A write copies the payload into
    its slot in place (``buf[slot].copy_``), where the reference rebinds
    its immutable slab. So a read returns a copy of the slot (one device
    copy of one payload per read; reads happen at finalize and on
    migration, not per step): a later write that reuses the slot cannot
    change a payload already read, as with the reference's immutable
    arrays."""

    def __init__(self, k: int, payload_shape, dtype=torch.float32,
                 device=None):
        self.k = k
        self._buf = torch.zeros((k,) + tuple(payload_shape), dtype=dtype,
                                device=device_mod.resolve(device))
        self._slot_of: Dict[int, int] = {}
        self._free = list(range(k))

    def put(self, doc_id: int, payload) -> int:
        if doc_id in self._slot_of:
            slot = self._slot_of[doc_id]
        else:
            if not self._free:
                raise RuntimeError("hot tier full — evict before writing")
            slot = self._free.pop()
            self._slot_of[doc_id] = slot
        self._buf[slot].copy_(torch.as_tensor(payload))
        return payload_nbytes(payload)

    def get(self, doc_id: int):
        return self._buf[self._slot_of[doc_id]].clone()

    def delete(self, doc_id: int) -> None:
        self._free.append(self._slot_of.pop(doc_id))

    def __contains__(self, doc_id: int) -> bool:
        return doc_id in self._slot_of

    def doc_ids(self):
        return list(self._slot_of)


class ColdTier:
    """Host-resident store: numpy copies keyed by doc id, optionally spilled
    to a directory (object-store stand-in). A tensor payload is copied
    when kept, so a caller that changes its tensor afterwards (a CPU
    tensor shares memory with its ``.numpy()``) does not change what was
    stored."""

    def __init__(self, directory: Optional[str] = None):
        self._mem: Dict[int, np.ndarray] = {}
        self._dir = directory
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _path(self, doc_id: int) -> str:
        return os.path.join(self._dir, f"doc_{doc_id}.npy")

    def put(self, doc_id: int, payload) -> int:
        arr = (payload.detach().cpu().numpy().copy()
               if isinstance(payload, torch.Tensor) else np.asarray(payload))
        if self._dir:
            np.save(self._path(doc_id), arr)
        else:
            self._mem[doc_id] = arr
        return arr.nbytes

    def get(self, doc_id: int):
        if self._dir:
            return np.load(self._path(doc_id))
        return self._mem[doc_id]

    def delete(self, doc_id: int) -> None:
        if self._dir:
            os.remove(self._path(doc_id))
        else:
            del self._mem[doc_id]

    def __contains__(self, doc_id: int) -> bool:
        if self._dir:
            return os.path.exists(self._path(doc_id))
        return doc_id in self._mem

    def doc_ids(self):
        if self._dir:
            return [int(f[4:-4]) for f in os.listdir(self._dir)
                    if f.startswith("doc_") and f.endswith(".npy")]
        return list(self._mem)


def payload_nbytes(payload) -> int:
    """Bytes of a numpy array or torch tensor payload."""
    return int(np.prod(payload.shape)) * payload.dtype.itemsize


class TieredStore:
    """N-tier payload store driven by an SHP placement policy.

    Constructed with one backing store per tier, ordered hot → cold
    (``TieredStore(policy, hot, cold)`` is the classic two-tier form;
    pass more stores for deeper hierarchies).

    Usage (inside the consumer side of a train/serve loop):
        store.write(doc_id, payload)          # tier chosen by policy(doc_id)
        store.evict(doc_id)                   # reservoir overwrote the doc
        store.maybe_migrate(stream_index)     # cascade at each boundary (Fig. 3)
        payloads = store.read_all(ids)        # the final top-K read
    """

    def __init__(self, policy: Policy, *tier_stores):
        if len(tier_stores) < 2:
            raise ValueError("need at least two tier stores (hot, cold)")
        if policy.n_tiers > len(tier_stores):
            raise ValueError(f"policy places across {policy.n_tiers} tiers "
                             f"but only {len(tier_stores)} stores given")
        self.policy = policy
        self.tiers = dict(enumerate(tier_stores))
        self.ledger = Ledger.sized(len(tier_stores))
        self._floor = 0  # highest boundary whose cascade has fired

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    def tier_index_of(self, doc_id: int) -> Optional[int]:
        for t, tier in self.tiers.items():
            if doc_id in tier:
                return t
        return None

    def write(self, doc_id: int, payload) -> int:
        t = max(self.policy.tier_of(doc_id), self._floor)
        t = min(t, self.n_tiers - 1)
        nbytes = self.tiers[t].put(doc_id, payload)
        self.ledger.writes[t] += 1
        self.ledger.bytes_written[t] += nbytes
        return t

    def evict(self, doc_id: int) -> None:
        t = self.tier_index_of(doc_id)
        if t is None:
            return
        self.tiers[t].delete(doc_id)
        self.ledger.deletes[t] += 1

    def _move(self, doc_id: int, src: int, dst: int) -> None:
        payload = self.tiers[src].get(doc_id)
        self.ledger.reads[src] += 1
        self.ledger.bytes_read[src] += payload_nbytes(payload)
        nbytes = self.tiers[dst].put(doc_id, payload)
        self.ledger.writes[dst] += 1
        self.ledger.bytes_written[dst] += nbytes
        self.tiers[src].delete(doc_id)

    def maybe_migrate(self, stream_index: int) -> int:
        """Fire every boundary the stream position has crossed at once:
        residents hop *directly* into the highest crossed tier, so
        zero-width tiers (coincident boundaries) are skipped — matching the
        planner's per-traversed-pair eq. 19 charge."""
        dst = self._floor
        for t, mig_at in enumerate(self.policy.migration_indices(), start=1):
            if t > dst and stream_index >= mig_at:
                dst = t
        if dst == self._floor:
            return 0
        moved = 0
        for src in range(self._floor, dst):
            for doc_id in self.tiers[src].doc_ids():
                self._move(doc_id, src, dst)
                moved += 1
        self._floor = dst
        self.ledger.migrations += moved
        return moved

    def read(self, doc_id: int):
        t = self.tier_index_of(doc_id)
        if t is None:
            raise KeyError(f"doc {doc_id} not stored")
        payload = self.tiers[t].get(doc_id)
        self.ledger.reads[t] += 1
        self.ledger.bytes_read[t] += payload_nbytes(payload)
        return payload

    def read_all(self, doc_ids):
        return {int(d): self.read(int(d)) for d in doc_ids}
