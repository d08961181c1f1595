"""Deterministic seed-driven fault injection for the ingest path — a copy
of the reference's ``resilience.faults``.

The harness models the delivery layer between a chunk producer and the
engine: chunks are addressed by a sequence number (the engine's ingest
cursor), deliveries may transiently fail, arrive twice, or arrive out of
order, scores may be laced with NaN/Inf, and the device may "die"
mid-stream. Every fault is a pure function of ``(seed, chunk seq)``, so
any failure is replayable bit-for-bit.

Recovery semantics (documented in the README's fault-tolerance table):
the delivery layer is at-least-once, the engine is exactly-once —
``ingest_with_faults`` drops deliveries below the cursor (idempotent
redelivery guard), buffers deliveries above it (reordering), and applies
each chunk exactly once in sequence order. ``run_with_recovery`` adds
crash recovery: on simulated device loss it rebuilds the engine,
restores the last checkpoint, and replays the schedule — the guard
silently absorbs everything already ingested before the checkpoint.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class TransientDeliveryError(RuntimeError):
    """A chunk delivery failed but is retryable."""


class DeviceLossError(RuntimeError):
    """The (simulated) accelerator died; state must be restored from the
    last checkpoint onto a fresh engine."""


class FaultyChunkSource:
    """Faulty delivery of ``make_chunk(i)`` for ``i in range(n_chunks)``.

    ``make_chunk`` must be a pure function of the chunk index — the
    retry, redelivery, and crash-recovery paths all re-materialize
    chunks from their index. Rates are per-delivery probabilities; all
    randomness derives from ``seed`` alone.

    * ``transient_rate`` — each chunk draws a deterministic number of
      leading failed delivery attempts (geometric, capped at
      ``max_transient`` so retry with enough attempts always succeeds).
    * ``duplicate_rate`` — after a delivery, an already-delivered chunk
      is redelivered (at-least-once delivery).
    * ``reorder_rate`` — adjacent deliveries swap (chunk t+1 arrives
      before chunk t).
    * ``nan_rate`` / ``nan_docs`` — a delivery has ``nan_docs`` of its
      live scores replaced by NaN / +Inf (the engine's quarantine path).
    * ``device_loss_at`` — delivering this seq raises
      ``DeviceLossError`` once (the crash under test).
    """

    def __init__(self, make_chunk: Callable[[int], List], n_chunks: int, *,
                 seed: int = 0, transient_rate: float = 0.0,
                 max_transient: int = 3, duplicate_rate: float = 0.0,
                 reorder_rate: float = 0.0, nan_rate: float = 0.0,
                 nan_docs: int = 1,
                 device_loss_at: Optional[int] = None):
        self._make = make_chunk
        self.n_chunks = int(n_chunks)
        self.seed = int(seed)
        self.transient_rate = float(transient_rate)
        self.max_transient = int(max_transient)
        self.duplicate_rate = float(duplicate_rate)
        self.reorder_rate = float(reorder_rate)
        self.nan_rate = float(nan_rate)
        self.nan_docs = int(nan_docs)
        self.device_loss_at = device_loss_at
        self._loss_fired = False
        # injection stats (what the source DID, vs the harness's stats
        # of what the guard then absorbed)
        self.failures_injected = 0
        self.duplicates_injected = 0
        self.nan_injected = 0

    def _failures(self, seq: int) -> int:
        """Deterministic leading-failure count for chunk ``seq``."""
        r = np.random.default_rng((self.seed, 7919, seq))
        n = 0
        while n < self.max_transient and r.random() < self.transient_rate:
            n += 1
        return n

    def _lace(self, seq: int, chunk: List) -> List:
        """Replace a few live scores with NaN/+Inf (seeded per chunk)."""
        r = np.random.default_rng((self.seed, 104729, seq))
        if self.nan_rate <= 0.0 or r.random() >= self.nan_rate:
            return chunk
        out = []
        laced = 0
        for scores, ids in chunk:
            scores = np.array(scores, np.float32, copy=True)
            live = np.argwhere(np.asarray(ids) >= 0)
            take = min(self.nan_docs - laced, live.shape[0])
            if take > 0:
                pick = live[r.choice(live.shape[0], size=take,
                                     replace=False)]
                vals = np.where(r.random(take) < 0.5, np.nan, np.inf)
                scores[pick[:, 0], pick[:, 1]] = vals.astype(np.float32)
                laced += take
            out.append((scores, ids))
        self.nan_injected += laced
        return out

    def fetch(self, seq: int, attempt: int = 0) -> List:
        """Deliver chunk ``seq`` (``ingest_dense``-shaped). Raises
        ``TransientDeliveryError`` on seeded failed attempts and
        ``DeviceLossError`` once at ``device_loss_at``."""
        if not 0 <= seq < self.n_chunks:
            raise IndexError(f"chunk {seq} outside [0, {self.n_chunks})")
        if (self.device_loss_at is not None and seq == self.device_loss_at
                and not self._loss_fired):
            self._loss_fired = True
            raise DeviceLossError(
                f"simulated device loss delivering chunk {seq}")
        if attempt < self._failures(seq):
            self.failures_injected += 1
            raise TransientDeliveryError(
                f"transient failure {attempt + 1} delivering chunk {seq}")
        return self._lace(seq, self._make(seq))

    def schedule(self) -> List[int]:
        """The seeded delivery order: every chunk at least once, plus
        duplicates, with adjacent reorderings applied."""
        rng = np.random.default_rng((self.seed, 15485863))
        order: List[int] = []
        for seq in range(self.n_chunks):
            order.append(seq)
            if rng.random() < self.duplicate_rate:
                order.append(int(rng.integers(0, seq + 1)))
                self.duplicates_injected += 1
        for i in range(1, len(order)):
            if rng.random() < self.reorder_rate:
                order[i - 1], order[i] = order[i], order[i - 1]
        return order


def fetch_with_retry(source, seq: int, *, max_attempts: int = 6,
                     base_delay: float = 0.05, jitter: float = 0.5,
                     sleep_scale: float = 1.0,
                     rng: Optional[np.random.Generator] = None,
                     stats: Optional[Dict] = None) -> List:
    """Retry a delivery with exponential backoff and jitter: attempt n
    sleeps ``base_delay · 2^n · (1 + jitter·U[0,1)) · sleep_scale``
    (``sleep_scale=0`` for tests). Re-raises after ``max_attempts``."""
    rng = rng if rng is not None else np.random.default_rng(0)
    last: Optional[Exception] = None
    for attempt in range(max_attempts):
        try:
            return source.fetch(seq, attempt)
        except TransientDeliveryError as e:
            last = e
            if stats is not None:
                stats["delivery_retries"] = \
                    stats.get("delivery_retries", 0) + 1
            delay = (base_delay * (2.0 ** attempt)
                     * (1.0 + jitter * float(rng.random())) * sleep_scale)
            if delay > 0:
                time.sleep(delay)
    raise last  # type: ignore[misc]


def ingest_with_faults(engine, source: FaultyChunkSource, *,
                       max_attempts: int = 6, base_delay: float = 0.05,
                       jitter: float = 0.5, sleep_scale: float = 1.0,
                       meter: bool = True,
                       stats: Optional[Dict] = None) -> Dict:
    """Drive an engine through the source's faulty delivery schedule.

    Exactly-once application against at-least-once delivery: deliveries
    below the engine's ingest cursor (or already buffered) are dropped
    by the idempotent redelivery guard; deliveries above it are buffered
    until their predecessors arrive; each chunk is applied exactly once,
    in sequence order. Propagates ``DeviceLossError`` (see
    ``run_with_recovery``). Returns harness stats; pass ``stats`` to
    accumulate into a caller-owned dict that survives a crash mid-run."""
    if stats is None:
        stats = {}
    for key in ("delivery_retries", "redeliveries_dropped",
                "chunks_applied"):
        stats.setdefault(key, 0)
    rng = np.random.default_rng((source.seed, 27644437))
    pending: Dict[int, List] = {}
    for seq in source.schedule():
        if seq < engine.chunks_ingested or seq in pending:
            stats["redeliveries_dropped"] += 1
            continue
        chunk = fetch_with_retry(source, seq, max_attempts=max_attempts,
                                 base_delay=base_delay, jitter=jitter,
                                 sleep_scale=sleep_scale, rng=rng,
                                 stats=stats)
        pending[seq] = chunk
        while engine.chunks_ingested in pending:
            engine.ingest_dense(pending.pop(engine.chunks_ingested),
                                meter=meter)
            stats["chunks_applied"] += 1
    if pending:
        # can only happen if the schedule lost a chunk — a bug, not a fault
        raise RuntimeError(f"undeliverable buffered chunks: "
                           f"{sorted(pending)} at cursor "
                           f"{engine.chunks_ingested}")
    return stats


def run_with_recovery(build_engine: Callable[[], object],
                      source: FaultyChunkSource, checkpointer, *,
                      max_restarts: int = 3, **ingest_kw
                      ) -> Tuple[object, Dict]:
    """Crash-resilient ingest loop: on ``DeviceLossError`` rebuild the
    engine with ``build_engine()``, restore the last checkpoint, and
    replay the delivery schedule — the redelivery guard absorbs every
    chunk the restored cursor already covers, so each chunk still
    applies exactly once. Returns ``(engine, stats)`` with
    ``stats["restarts"]`` counting recoveries."""
    engine = build_engine()
    engine.attach_checkpointer(checkpointer)
    totals: Dict = {"restarts": 0}
    while True:
        try:
            ingest_with_faults(engine, source, stats=totals, **ingest_kw)
            return engine, totals
        except DeviceLossError:
            totals["restarts"] += 1
            if totals["restarts"] > max_restarts:
                raise
            checkpointer.wait()
            engine = build_engine()
            checkpointer.restore(engine)
            engine.attach_checkpointer(checkpointer)
