# Model-referenced fleet telemetry (repro_torch.obs, the port of the
# reference's repro.obs): the paper's closed-form laws make every fleet
# counter predictable, so the observability layer exports residuals
# (realized − expected) instead of raw gauges.
#   metrics   — device-side MetricsState carried through the engine step
#               (no device→host copy in the step; drained at snapshot)
#   residuals — realized vs closed-form expectation + z-scores for the
#               write/occupancy/latency laws; ResidualMonitor alert
#               channel (concentration-bound, fires at or before CUSUM)
#   costs     — device-side CostState ledger + closed-form expected-cost
#               trajectories, per-tenant regret, and budget burn-rate
#               alerts (CostMonitor)
#   trace     — span/event timeline with a stable JSONL schema and
#               torch.profiler record_function integration
#   jits      — compile-cache hit/miss + compile-time probes (the
#               kernels' nvcc build, kernels.build)
#   timers    — the shared benchmark/evaluation timing API
#   export    — Prometheus text exposition + JSON snapshots
"""Fleet observability: configuration and the per-run facade.

``Observability`` is the object callers thread through the system::

    obs = Observability(ObsConfig(events_path="events.jsonl"))
    engine = StreamEngine(specs, obs=obs)
    ...
    snap = obs.snapshot()            # device metrics + residuals + jit
    print(export.to_prometheus(snap))
    obs.write(out_dir)               # metrics.json / metrics.prom / events

It owns the tracer (span timeline + JSONL sink) and gathers, on demand,
the engine's device counters, the meter's ledger aggregates, the
model-referenced residual metrics, and the process-wide compile-cache
probes. The engine never copies the device counters to the host except
inside ``snapshot``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

from . import export, jits, timers, trace  # noqa: F401
from .trace import Tracer  # noqa: F401


@dataclass(frozen=True)
class ObsConfig:
    """Static observability configuration.

    ``metrics``: carry the device ``MetricsState`` through the engine
    step. ``residuals``: maintain the ``ResidualMonitor`` alert channel
    (per-chunk host update from the meter drain). ``residual_trigger``:
    feed residual alerts to the ``Replanner`` as an earlier trigger
    (requires the engine's ``replan=`` config; alerts then reset like
    detector evidence). ``costs``: carry the device ``CostState``
    ledger through the engine step and maintain the ``CostMonitor``
    cost-residual / budget burn-rate alert channel (``obs.costs``).
    ``cost_trigger``: union cost/burn alerts into the re-plan trigger
    exactly like ``residual_trigger``. ``budget_factor``: overspend
    budget — burn alerts require realized > threshold × budget_factor ×
    planned on both windows of a ``burn_windows`` (long, short,
    threshold) pair. ``events_path``: stream the event log to this
    JSONL file. ``profiler_annotations``: mirror spans into the PyTorch
    profiler timeline (``torch.profiler.record_function``).
    ``trace_ingest``: record a span per ingest chunk (point events for
    replan/admission/violations are always recorded).
    """

    metrics: bool = True
    residuals: bool = True
    residual_alpha: float = 0.01
    residual_max_checks: int = 1024
    residual_trigger: bool = False
    costs: bool = False
    cost_alpha: float = 0.01
    cost_max_checks: int = 1024
    cost_trigger: bool = False
    budget_factor: float = 1.2
    burn_windows: tuple = ((8, 2, 1.5), (32, 8, 1.2))
    events_path: Optional[str] = None
    profiler_annotations: bool = False
    trace_ingest: bool = True
    max_events: int = 100_000


class Observability:
    """Per-run facade: tracer + snapshot/exposition over attached engines."""

    def __init__(self, config: Optional[ObsConfig] = None):
        self.config = config or ObsConfig()
        self.tracer = Tracer(self.config.events_path,
                             annotations=self.config.profiler_annotations,
                             max_events=self.config.max_events)
        self._engines: List[object] = []

    def attach(self, engine) -> None:
        """Called by ``StreamEngine.__init__`` when passed ``obs=``."""
        self._engines.append(engine)

    # ---- snapshots ------------------------------------------------------

    def snapshot(self) -> dict:
        """One nested dict of everything: per-engine device counters,
        meter aggregates, residual metrics, and the process-wide
        compile-cache probe counters."""
        out: dict = {"jit": jits.snapshot(),
                     "events": {"recorded": len(self.tracer.events),
                                "dropped": self.tracer.dropped}}
        engines = {}
        for i, eng in enumerate(self._engines):
            engines[f"engine{i}"] = eng.obs_snapshot()
        out["engines"] = engines
        return out

    def prometheus(self, prefix: str = "repro_obs") -> str:
        return export.to_prometheus(self.snapshot(), prefix=prefix)

    def write(self, out_dir: str) -> dict:
        """Write ``metrics.json``, ``metrics.prom`` and (if not already
        streaming) ``events.jsonl`` under ``out_dir``; returns paths."""
        os.makedirs(out_dir, exist_ok=True)
        snap = self.snapshot()
        paths = {
            "metrics": export.write_snapshot(
                os.path.join(out_dir, "metrics.json"), snap),
        }
        prom = os.path.join(out_dir, "metrics.prom")
        with open(prom, "w") as f:
            f.write(export.to_prometheus(snap))
        paths["prometheus"] = prom
        if self.config.events_path is None:
            paths["events"] = self.tracer.write(
                os.path.join(out_dir, "events.jsonl"))
        else:
            paths["events"] = self.config.events_path
        return paths


def __getattr__(name: str):
    # residuals/metrics/costs import the engine's laws and torch — lazy
    # so importing repro_torch.obs.jits from the kernel build cannot
    # cycle back through them
    if name in ("residuals", "metrics", "costs", "http"):
        import importlib
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
