"""Router: scatter a mixed multi-tenant batch of scored docs into dense
per-bucket arrays the batched engine can consume.

Streams are bucketed by K — every stream in a bucket shares one reservoir
width, so the bucket's state is a dense ``(M_bucket, K)`` array and one
vectorized sort-merge updates all of them. A mixed ingest batch
(stream_id, score, doc_id) triples in arbitrary order — is grouped by
bucket, then scattered into ``(M_bucket, W)`` matrices padded with
``(-inf, -1)``; each stream's row is ordered by doc id (= stream
position), which makes routing deterministic and guarantees the
id-increasing order the kernel-filtered engine path needs for its
tie-break to match the exact merge. ``W`` is rounded up to a power of two
to bound the number of distinct shapes the jitted engine step compiles
for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD_SCORE = -np.inf
PAD_ID = -1


@dataclass(frozen=True)
class Bucket:
    """All streams sharing one reservoir width K *and* one engine
    backend (``"exact"`` O(K) reservoir or ``"logmem"`` O(log K)
    threshold tracker — the per-bucket state pytrees differ, so mixed
    backends cannot share a bucket). ``stream_ids[row]`` maps the
    bucket-local row back to the global stream id."""

    k: int
    stream_ids: Tuple[int, ...]
    engine: str = "exact"

    @property
    def m(self) -> int:
        return len(self.stream_ids)


def bucket_streams(ks: Dict[int, int],
                   engines: Dict[int, str] | None = None) -> List[Bucket]:
    """Group streams (stream_id → K, optionally stream_id → engine) into
    per-(K, engine) buckets, ordered by (K, engine) ascending and rows
    ordered by stream id — deterministic layout."""
    by_key: Dict[Tuple[int, str], List[int]] = {}
    for sid, k in ks.items():
        eng = engines.get(sid, "exact") if engines else "exact"
        by_key.setdefault((int(k), str(eng)), []).append(int(sid))
    return [Bucket(k=k, stream_ids=tuple(sorted(by_key[(k, eng)])),
                   engine=eng)
            for k, eng in sorted(by_key)]


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def blank_dense(m: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scores (m, w) f32, doc_ids (m, w) i32) of all-pad rows — the one
    inert filler every staging path shares: ``route`` scatters live docs
    into it, and the engine's shard padding appends whole blank rows.
    Every law (update, drift, metrics, meter) treats (PAD_SCORE, PAD_ID)
    entries as absent; tests assert the inertness through both engine
    backends."""
    return (np.full((m, w), PAD_SCORE, np.float32),
            np.full((m, w), PAD_ID, np.int32))


class StreamRouter:
    """Routes mixed batches to bucket-dense matrices (numpy, host-side)."""

    def __init__(self, buckets: Sequence[Bucket]):
        self.buckets = list(buckets)
        sids, bis, rows = [], [], []
        for bi, b in enumerate(self.buckets):
            for row, sid in enumerate(b.stream_ids):
                sids.append(sid)
                bis.append(bi)
                rows.append(row)
        order = np.argsort(sids)
        self._sids = np.asarray(sids, np.int64)[order]
        if np.any(np.diff(self._sids) == 0):
            raise ValueError("duplicate stream id across buckets")
        self._bi = np.asarray(bis, np.int64)[order]
        self._row = np.asarray(rows, np.int64)[order]

    def lookup(self, stream_ids) -> Tuple[np.ndarray, np.ndarray]:
        """stream_ids (S,) → (bucket_index (S,), bucket_row (S,))."""
        stream_ids = np.asarray(stream_ids, np.int64)
        pos = np.searchsorted(self._sids, stream_ids)
        ok = (pos < self._sids.shape[0]) & \
            (self._sids[np.minimum(pos, self._sids.shape[0] - 1)] == stream_ids)
        if not np.all(ok):
            bad = np.unique(stream_ids[~ok])
            raise KeyError(f"unregistered stream ids: {bad[:8].tolist()}")
        return self._bi[pos], self._row[pos]

    def route(self, stream_ids, scores, doc_ids, *, pad_to: int | None = None
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Scatter a mixed batch into one dense (scores, doc_ids) pair per
        bucket, aligned with ``self.buckets``.

        Returns ``[(scores (M_b, W_b) f32, doc_ids (M_b, W_b) i32), ...]``
        padded with ``(PAD_SCORE, PAD_ID)``. ``W_b`` = max docs routed to
        any stream of the bucket this batch, rounded up to a power of two
        (or ``pad_to`` if given and larger). Each row is sorted by doc id.
        """
        scores = np.asarray(scores, np.float32).reshape(-1)
        doc_ids = np.asarray(doc_ids, np.int32).reshape(-1)
        bi, row = self.lookup(stream_ids)
        out = []
        for b_idx, bucket in enumerate(self.buckets):
            sel = np.flatnonzero(bi == b_idx)
            rows = row[sel]
            # group by row, then stream order within each row
            order = np.lexsort((doc_ids[sel], rows))
            rs = rows[order]
            ds = doc_ids[sel][order]
            dup = (np.diff(rs) == 0) & (np.diff(ds) == 0)
            if np.any(dup):
                j = int(np.flatnonzero(dup)[0])
                raise ValueError(
                    f"duplicate (stream, doc) in one batch: stream "
                    f"{bucket.stream_ids[rs[j]]} doc {ds[j]} — a doc id may "
                    f"appear once per stream per ingest")
            if rs.size:
                starts = np.r_[0, np.flatnonzero(np.diff(rs)) + 1]
                counts = np.diff(np.r_[starts, rs.size])
                pos = np.arange(rs.size) - np.repeat(starts, counts)
                width = int(counts.max())
            else:
                pos = rs
                width = 0
            w = _next_pow2(max(width, 1))
            if pad_to is not None:
                w = max(w, int(pad_to))
            dense_s, dense_i = blank_dense(bucket.m, w)
            dense_s[rs, pos] = scores[sel][order]
            dense_i[rs, pos] = doc_ids[sel][order]
            out.append((dense_s, dense_i))
        return out
