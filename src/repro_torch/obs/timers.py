"""The shared timing API (the port of the reference's ``obs.timers``):

* ``time_torch`` — device timing, the counterpart of the reference's
  ``time_jax``: one warm-up call, then ``reps`` back-to-back calls
  between two ``torch.cuda.synchronize`` (on a CUDA device; the CPU runs
  synchronously). Returns microseconds per call.
* ``time_best`` — host-call timing: best of ``repeats`` full wall-clock
  runs. Returns seconds.
* ``span`` — a ``perf_counter`` interval usable bare (returns an object
  whose ``.dur_s`` is set on exit) or recorded into a ``trace.Tracer``.

``online.evaluate`` measures through this module.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_torch(fn, *args, reps: int = 20, **kwargs) -> float:
    """Steady-state microseconds per call of a torch callable."""
    fn(*args, **kwargs)  # warm-up: kernel builds, allocator
    _sync()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn(*args, **kwargs)
    _sync()
    return (time.perf_counter_ns() - t0) / 1000.0 / reps


def time_best(fn, repeats: int = 3) -> float:
    """Best-of-``repeats`` wall seconds of a host call."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


class Span:
    """Result object of ``span`` — ``dur_s`` is valid after the block."""

    __slots__ = ("name", "dur_s")

    def __init__(self, name: str):
        self.name = name
        self.dur_s = 0.0


@contextmanager
def span(name: str, tracer=None, **attrs):
    """Time a block; mirrors into ``tracer`` (a ``trace.Tracer``) when
    one is given, so ad-hoc timing and the event timeline share records."""
    if tracer is not None:
        with tracer.span(name, **attrs):
            sp = Span(name)
            t0 = time.perf_counter()
            yield sp
            sp.dur_s = time.perf_counter() - t0
        return
    sp = Span(name)
    t0 = time.perf_counter()
    yield sp
    sp.dur_s = time.perf_counter() - t0

