"""Per-tier transaction ledger (``Ledger``), the one piece of the
reference's ``core.tiers`` the fleet meter needs. ``TieredStore``, the
runtime that holds payloads across tiers, is not ported yet (ROADMAP
queue 1 item 10).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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
