"""Device-side metric accumulators for the engine step — the port of the
reference's ``obs.metrics``.

``MetricsState`` is carried through ``streams.engine.step``. Every update
is computed from tensors the step already materializes (the batch ids,
the write mask, the eviction ids, the pre-update reservoir bar, the
drift state) as a handful of tensor reductions queued on the engine's
device behind the step's own work. None of them reads a value back to
the host: the counters stay on the device until ``snapshot`` drains them
(one device→host copy), and with metrics off the step runs exactly the
operations it runs without obs, so obs-off output is bit-identical.

The integer counters are packed into ONE ``(8,)`` int32 tensor, in the
reference's slot order, plus a float32 scalar for the drift score. Drain
and rebase into the host-side accumulator before a window approaches
2^31 docs.

Under a fleet mesh (``StreamEngine(mesh=...)``) the reference's sharded
layout applies: counts ``(D, 8)`` and score ``(D,)``, one block a shard.
Each shard accumulates its own block in the flat layout
(``shard_local``; ``shard_pack`` re-adds the shard axis), so the step
stays free of cross-shard work; ``snapshot`` and ``to_canonical``
aggregate across shards on the device before their one transfer.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod

# slots of the packed counter vector
(DOCS, ADMITS, EVICTIONS, BAR_CANDIDATES, BAR_PASSES, CHUNKS, DRIFT_FIRED,
 SCORES_QUARANTINED) = range(8)
N_SLOTS = 8


class MetricsState(NamedTuple):
    """Fleet-level counters, accumulated on the device: flat, or with a
    leading shard axis under a fleet mesh (counts ``(D, 8)``, score
    ``(D,)``), aggregated by ``snapshot``."""

    counts: torch.Tensor  # (8,) int32 — or (D, 8); see the slots above
    drift_score_max: torch.Tensor  # () float32 — or (D,)

    @property
    def sharded(self) -> bool:
        return self.counts.dim() == 2


def init(device=None, shards: int = 0) -> MetricsState:
    """Zeroed counters on ``device`` (the CUDA card unless given);
    ``shards > 0`` builds the sharded layout (one block a shard)."""
    dev = device_mod.resolve(device)
    lead = (shards,) if shards else ()
    return MetricsState(
        counts=torch.zeros(lead + (N_SLOTS,), dtype=torch.int32, device=dev),
        drift_score_max=torch.zeros(lead, dtype=torch.float32, device=dev))


def shard_local(ms: MetricsState) -> MetricsState:
    """A shard's (1, 8) / (1,) block in the flat layout that every
    accumulate law takes."""
    return MetricsState(counts=ms.counts[0],
                        drift_score_max=ms.drift_score_max[0])


def shard_pack(ms: MetricsState) -> MetricsState:
    """Inverse of ``shard_local``: re-add the leading shard axis."""
    return MetricsState(counts=ms.counts[None],
                        drift_score_max=ms.drift_score_max[None])


def _at(counts: torch.Tensor, slot: int, value) -> torch.Tensor:
    """An (8,) int32 tensor holding ``value`` (a 0-d device tensor or an
    int) in ``slot`` and zeros elsewhere, built on the device: an
    assignment ``t[slot] = 1`` would copy the int from the host and wait
    for the device."""
    onehot = torch.arange(N_SLOTS, device=counts.device) == slot
    return torch.where(onehot, value, 0).to(torch.int32)


def accumulate_bucket(ms: MetricsState, batch_scores, batch_ids, bar,
                      wrote, evicted) -> MetricsState:
    """Fold one bucket's step outputs into the counters. ``bar`` is the
    pre-update entry bar (``state.scores[:, -1]``, or a logmem bucket's
    ``tau``): the filter pass rate is the fraction of live candidates
    scoring above it — on unfull reservoirs the bar is -inf and every
    candidate passes, matching the filter."""
    live = batch_ids >= 0
    i32 = torch.int32
    docs = live.sum(dtype=i32)
    z = torch.zeros((), dtype=i32, device=docs.device)
    delta = torch.stack([
        docs,                                                 # DOCS
        wrote.sum(dtype=i32),                                 # ADMITS
        (evicted >= 0).sum(dtype=i32),                        # EVICTIONS
        docs,                                                 # BAR_CANDIDATES
        (live & (batch_scores > bar[:, None])).sum(dtype=i32),  # BAR_PASSES
        z, z, z])
    return ms._replace(counts=ms.counts + delta)


def accumulate_quarantine(ms: MetricsState, count) -> MetricsState:
    """Count non-finite scores the step swapped out for pad slots before
    they could poison the reservoir compares (NaN fails every compare)."""
    return ms._replace(counts=ms.counts
                       + _at(ms.counts, SCORES_QUARANTINED, count))


def accumulate_drift(ms: MetricsState, score_max, fired_count
                     ) -> MetricsState:
    """Fold the drift detector's per-step summary (max normalized score,
    latched fire count) into the counters."""
    onehot = torch.arange(N_SLOTS, device=ms.counts.device) == DRIFT_FIRED
    return MetricsState(
        counts=torch.where(onehot, fired_count, ms.counts),
        drift_score_max=torch.maximum(ms.drift_score_max, score_max))


def bump_chunk(ms: MetricsState) -> MetricsState:
    return ms._replace(counts=ms.counts + _at(ms.counts, CHUNKS, 1))


def _collapse(ms: MetricsState) -> MetricsState:
    """A sharded state's fleet-global counters, on the device: counts sum
    across shards (exact), CHUNKS and the drift high-water mark take the
    cross-shard max (every shard bumps CHUNKS once a chunk)."""
    if not ms.sharded:
        return ms
    onehot = torch.arange(N_SLOTS, device=ms.counts.device) == CHUNKS
    counts = torch.where(onehot, ms.counts.amax(dim=0),
                         ms.counts.sum(dim=0, dtype=torch.int32))
    return MetricsState(counts=counts,
                        drift_score_max=ms.drift_score_max.amax())


def _drain(ms: MetricsState) -> Tuple[np.ndarray, np.float32]:
    """The fleet-global counters and the drift score through one
    device→host copy: the score's bits ride as a ninth int32."""
    ms = _collapse(ms)
    host = torch.cat([ms.counts, ms.drift_score_max.reshape(1).view(
        torch.int32)]).cpu().numpy()
    return host[:N_SLOTS].copy(), host[N_SLOTS:].view(np.float32)[0]


def snapshot(ms: MetricsState) -> dict:
    """Drain the device counters to host scalars (the only sync point);
    a sharded state reports fleet-global numbers, never one shard's."""
    c, score = _drain(ms)
    cand, passes = int(c[BAR_CANDIDATES]), int(c[BAR_PASSES])
    return {
        "docs": int(c[DOCS]),
        "admits": int(c[ADMITS]),
        "evictions": int(c[EVICTIONS]),
        "bar_candidates": cand,
        "bar_passes": passes,
        "filter_pass_rate": passes / cand if cand else 0.0,
        "chunks": int(c[CHUNKS]),
        "drift_score_max": float(score),
        "drift_fired": int(c[DRIFT_FIRED]),
        "scores_quarantined": int(c[SCORES_QUARANTINED]),
    }


def to_canonical(ms: MetricsState) -> Tuple[np.ndarray, np.float32]:
    """The mesh-independent host form ``(counts (8,) int32, score
    float32)`` used by checkpoints: ``snapshot``'s aggregation."""
    return _drain(ms)


def from_canonical(counts, score, device=None,
                   shards: int = 0) -> MetricsState:
    """Rebuild a device state from the canonical form, flat or onto
    ``shards`` blocks: the aggregate lands in shard 0's block with the
    rest zeroed, so later accumulation and the sum/max aggregation give
    the uninterrupted run's numbers at any shard count."""
    dev = device_mod.resolve(device)
    counts = np.asarray(counts, np.int32).reshape(N_SLOTS)
    if shards:
        c = np.zeros((shards, N_SLOTS), np.int32)
        c[0] = counts
        s = np.zeros((shards,), np.float32)
        s[0] = score
        return MetricsState(counts=torch.tensor(c, device=dev),
                            drift_score_max=torch.tensor(s, device=dev))
    return MetricsState(
        counts=torch.tensor(counts, device=dev),
        drift_score_max=torch.tensor(np.float32(score), device=dev))
