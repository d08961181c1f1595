"""Compile-cache introspection: hit/miss and compile-time counters — the
port of the reference's ``obs.jits`` probe registry.

The reference probes its ``jax.jit``-ed planner entry points, whose
compiled-signature cache a varying static signature can turn into a
compile storm. The port runs eagerly: torch compiles nothing per call,
so its planner entry points have no cache to probe. Its one compile
cache is the kernels' ``nvcc`` build under ``build/kernels/``
(``kernels.build``), and that build reports to the probe
``"kernels.build"``: a kernel compiled by ``nvcc`` is a miss (its
``compile_s`` the wall time until that ``nvcc`` exits), a library loaded
from the cache, or found up to date by a build, is a hit. The per-key
tallies are keyed by kernel name.

``JitProbe.track`` keeps the reference's interface (it reads a callable's
``_cache_size`` where the callable has one); ``record`` books a call
whose outcome the caller already knows, as the kernel build does.
Probes live in a module-level registry so the build and the export
layer need no shared plumbing. Counters are lock-protected. ``mesh_key``
gives a fleet mesh's shape component for keys, as the reference's.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

_REGISTRY: Dict[str, "JitProbe"] = {}
_REGISTRY_LOCK = threading.Lock()


def _cache_size(fn) -> Optional[int]:
    """Compiled-signature count of a callable, or None when it exposes
    none (the probe then degrades to call counts)."""
    getter = getattr(fn, "_cache_size", None)
    if getter is None:
        return None
    try:
        return int(getter())
    except Exception:
        return None


class JitProbe:
    """Hit/miss/compile-time counters for one compiled entry point."""

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.hits = 0
        self.misses = 0
        self.compile_s = 0.0  # wall time of missing calls (compile + run)
        self.cache_size = 0  # compiled entries at the last tracked call
        self.by_key: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def track(self, fn, *args, key=None, **kwargs):
        """Call ``fn(*args, **kwargs)`` and account whether it compiled.
        ``key`` labels the static signature (per-key tallies)."""
        before = _cache_size(fn)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        after = _cache_size(fn)
        missed = (after is not None and before is not None
                  and after > before)
        self.record(missed, dt, key=key, cache_size=after)
        return out

    def record(self, missed: bool, seconds: float, *, key=None,
               cache_size: Optional[int] = None) -> None:
        """Book one call: a miss adds ``seconds`` to ``compile_s``."""
        with self._lock:
            self.calls += 1
            if missed:
                self.misses += 1
                self.compile_s += seconds
            else:
                self.hits += 1
            if cache_size is not None:
                self.cache_size = cache_size
            if key is not None:
                kd = self.by_key.setdefault(
                    str(key), {"calls": 0, "misses": 0, "compile_s": 0.0})
                kd["calls"] += 1
                if missed:
                    kd["misses"] += 1
                    kd["compile_s"] += seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {"calls": self.calls, "hits": self.hits,
                    "misses": self.misses,
                    "compile_s": round(self.compile_s, 6),
                    "cache_size": self.cache_size,
                    "by_key": {k: dict(v) for k, v in self.by_key.items()}}

    def reset(self) -> None:
        with self._lock:
            self.calls = self.hits = self.misses = 0
            self.compile_s = 0.0
            self.by_key.clear()


def mesh_key(mesh) -> tuple:
    """Canonical mesh-shape component for probe keys: ``((axis, size),
    ...)`` — ``(("fleet", D),)`` for a ``parallel.fleet.FleetMesh`` of D
    shards — or ``()`` without a mesh, as the reference's."""
    if mesh is None:
        return ()
    return tuple((str(a), int(mesh.shape[a])) for a in mesh.axis_names)


def probe(name: str) -> JitProbe:
    """Get-or-create the named probe."""
    with _REGISTRY_LOCK:
        p = _REGISTRY.get(name)
        if p is None:
            p = _REGISTRY[name] = JitProbe(name)
        return p


def snapshot() -> Dict[str, dict]:
    """{probe name: counters} for every registered probe."""
    with _REGISTRY_LOCK:
        probes = list(_REGISTRY.values())
    return {p.name: p.snapshot() for p in probes}


def reset() -> None:
    """Zero every probe's counters (the probes stay registered)."""
    with _REGISTRY_LOCK:
        probes = list(_REGISTRY.values())
    for p in probes:
        p.reset()
