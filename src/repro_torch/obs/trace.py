"""Structured event tracing: span timeline + JSONL event log.

``Tracer`` records two event kinds into one append-only timeline:

* ``span`` — a named interval (``with tracer.span("ingest"): ...``) with
  wall-clock start and duration, optionally mirrored into the PyTorch
  profiler timeline as a ``torch.profiler.record_function`` range so host
  spans line up with device activity in a captured trace;
* ``event`` — a named point record (``tracer.emit("replan", ...)``).

Every record is one JSON object with a stable schema (``SCHEMA``):

    {"v": 1, "kind": "span"|"event", "name": str, "ts": unix seconds,
     "dur_s": float|null, "attrs": {...}}

Records are kept in a bounded in-memory deque (``max_events``, oldest
dropped) and, when ``path`` is given, streamed to a JSONL file as they
complete — a long-running fleet never grows host memory without bound
and never loses the on-disk log to a crash. Attribute values must be
JSON-serializable scalars/lists; numpy scalars are coerced.

A copy of the reference's ``obs.trace`` with the same record schema and
JSONL; the profiler annotation is torch's.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterable, Optional

import torch

SCHEMA = "repro.obs/v1"


def _coerce(v):
    """Make attribute values JSON-clean (numpy scalars/arrays included)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_coerce(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _coerce(x) for k, x in v.items()}
    item = getattr(v, "item", None)  # numpy scalars, 0-d tensors
    if item is not None and getattr(v, "ndim", 1) == 0:
        return item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return tolist()
    return repr(v)


class Tracer:
    """Span/event recorder with an optional streaming JSONL sink."""

    def __init__(self, path: Optional[str] = None, *,
                 annotations: bool = False, max_events: int = 100_000):
        self.events: deque = deque(maxlen=max_events)
        self.annotations = annotations
        self._path = path
        self._fh = None
        self.dropped = 0  # records evicted from the in-memory deque

    # ---- recording ------------------------------------------------------

    def _record(self, rec: dict) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(rec)
        if self._path is not None:
            if self._fh is None:
                self._fh = open(self._path, "a")
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()

    def emit(self, name: str, **attrs) -> dict:
        """Record one point event."""
        rec = {"v": 1, "kind": "event", "name": str(name),
               "ts": time.time(), "dur_s": None,
               "attrs": {k: _coerce(v) for k, v in attrs.items()}}
        self._record(rec)
        return rec

    @contextmanager
    def span(self, name: str, **attrs):
        """Record one named interval; yields the (mutable) attrs dict so
        the body can attach results before the span closes."""
        out = {k: _coerce(v) for k, v in attrs.items()}
        ts = time.time()
        t0 = time.perf_counter()
        if self.annotations:
            with torch.profiler.record_function(str(name)):
                yield out
        else:
            yield out
        self._record({"v": 1, "kind": "span", "name": str(name), "ts": ts,
                      "dur_s": time.perf_counter() - t0,
                      "attrs": {k: _coerce(v) for k, v in out.items()}})

    # ---- draining -------------------------------------------------------

    def spans(self, name: Optional[str] = None) -> Iterable[dict]:
        return [e for e in self.events
                if e["kind"] == "span" and (name is None or e["name"] == name)]

    def write(self, path: str) -> str:
        """Dump the in-memory timeline to a JSONL file (one record per
        line; independent of the streaming sink)."""
        with open(path, "w") as f:
            for rec in self.events:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return path

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
