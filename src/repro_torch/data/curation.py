"""TopKCurator — the paper's workflow embedded in a train or serve loop: a
copy of the reference's ``data.curation`` with its imports rewritten.

The loop scores each example (per-example interestingness); the curator
is the host-side consumer: it keeps the top-K (ties to the lower id),
executes tier placement for the retained payloads through a TieredStore,
performs the bulk migration at i = r (Fig. 3), and serves the
end-of-window read — while reconciling its transaction ledger against the
analytic expectations.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core import shp
from repro_torch.core.costs import NTierCostModel, TwoTierCostModel
from repro_torch.core.placement import Policy, optimal_policy
from repro_torch.core.tiers import TieredStore


@dataclass
class CurationStats:
    observed: int = 0
    writes: int = 0
    evictions: int = 0
    migrated: int = 0

    def as_dict(self):
        return self.__dict__.copy()


class TopKCurator:
    def __init__(self, k: int, store: TieredStore,
                 cost_model: Optional[TwoTierCostModel | NTierCostModel] = None,
                 policy: Optional[Policy] = None):
        if policy is None:
            if cost_model is None:
                raise ValueError("need cost_model or policy")
            policy = optimal_policy(cost_model)
        self.k = k
        self.store = store
        self.store.policy = policy
        self.policy = policy
        self.cost_model = cost_model
        self._heap: list[tuple[float, int]] = []  # (score, -id): weakest on top
        self.stats = CurationStats()

    @property
    def threshold(self) -> float:
        return self._heap[0][0] if len(self._heap) >= self.k else -np.inf

    def observe_batch(self, ids, scores, payloads) -> CurationStats:
        """ids (B,) int — scores (B,) float — payloads: id-indexable arrays."""
        ids = np.asarray(ids)
        scores = np.asarray(scores, np.float64)
        order = np.argsort(ids)  # stream order within the batch
        for j in order:
            doc = int(ids[j])
            self.stats.observed += 1
            self.store.maybe_migrate(doc)
            entry = (float(scores[j]), -doc)
            if len(self._heap) < self.k:
                accepted = True
            elif entry > self._heap[0]:
                _, neg = heapq.heappop(self._heap)
                self.store.evict(-neg)
                self.stats.evictions += 1
                accepted = True
            else:
                accepted = False
            if accepted:
                heapq.heappush(self._heap, entry)
                self.store.write(doc, payloads[j])
                self.stats.writes += 1
        self.stats.migrated = self.store.ledger.migrations
        return self.stats

    def survivor_ids(self) -> np.ndarray:
        return np.array(sorted(-neg for _, neg in self._heap), dtype=np.int64)

    def finalize(self) -> Dict[int, np.ndarray]:
        """End-of-window read of the top-K payloads (the consumer side)."""
        return self.store.read_all(self.survivor_ids())

    def expected_writes(self) -> float:
        """Analytic prediction for the observed stream position (eq. 11/12)."""
        n = max(self.stats.observed, 1)
        return float(shp.expected_cum_writes(n - 1, self.k))
