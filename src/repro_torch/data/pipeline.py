"""Elastic, deterministic, sharded stream loader — a NumPy copy of the
reference's ``data.pipeline`` with its imports rewritten.

Every example has a global identity ``id = step·global_batch + slot``; a
worker materializes exactly its slice as a pure function of
(seed, step, dp_rank, dp_size). Properties (tested):

* determinism — same (seed, step) ⇒ same global batch, any worker set;
* elasticity  — changing dp_size re-partitions the SAME global stream
  (union over ranks is invariant), so scale-up/down needs no data replay;
* resumability — restart at step s reproduces the stream from s.

These are the fault-tolerance guarantees the train loop builds on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from .synthetic import make_batch


@dataclass
class ShardInfo:
    dp_rank: int = 0
    dp_size: int = 1


class StreamLoader:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 shard: Optional[ShardInfo] = None,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.shard = shard or ShardInfo()
        self.global_batch = batch_override or shape.global_batch
        self.seq_len = seq_override or shape.seq_len
        if self.global_batch % self.shard.dp_size:
            raise ValueError("global_batch must divide dp_size")

    def example_ids(self, step: int) -> np.ndarray:
        per = self.global_batch // self.shard.dp_size
        base = step * self.global_batch + self.shard.dp_rank * per
        return np.arange(base, base + per, dtype=np.int64)

    def batch_for_step(self, step: int) -> dict:
        ids = self.example_ids(step)
        out = make_batch(self.cfg, self.shape, seed=self.seed, step=0,
                         indices=ids, seq_len=self.seq_len)
        out["example_ids"] = (ids % (2 ** 31 - 1)).astype(np.int32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_for_step(step)
            step += 1
