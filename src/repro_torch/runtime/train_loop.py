"""Fault-tolerant training loop — the port of the reference's
``runtime.train_loop``.

Failure model: any step may be interrupted (SIGTERM/preemption), any node
may straggle. Mechanisms:

* auto-resume — on start, restore the newest valid checkpoint (atomic
  manifests mean a torn save is never selected);
* preemption — SIGTERM/SIGINT set a flag; the loop checkpoints at the next
  step boundary and exits cleanly, restoring the previous handlers;
* straggler watchdog — per-step wall times in a ring buffer; steps slower
  than ``straggler_factor`` × median are logged and counted;
* elastic data — the loader is (step, rank, size)-addressable, so resuming
  with a different dp size replays no data and skips none;
* curation — the SHP reservoir runs inside the step (on the device) and
  the host curator places the retained payloads.

The step's batch is copied to the state's device before the step; the
read of the loss after it is the step's one sync, as in the reference.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import StreamLoader
from repro_torch.runtime import steps as steps_mod


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    lr: float = 3e-4
    straggler_factor: float = 3.0
    straggler_window: int = 64


@dataclass
class LoopReport:
    steps_run: int = 0
    resumed_from: Optional[int] = None
    interrupted: bool = False
    straggler_steps: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


def run(cfg, loader: StreamLoader, *, loop: LoopConfig,
        ckpt: Optional[CheckpointManager] = None,
        curator=None, seed: int = 0,
        on_metrics: Optional[Callable[[int, dict], None]] = None,
        device=None) -> LoopReport:
    """Train ``cfg`` on ``loader``'s stream up to ``loop.total_steps`` on
    ``device`` (the CUDA card unless given), resuming from ``ckpt``'s
    newest checkpoint when there is one. The final state is
    ``report.final_state``."""
    dev = device_mod.resolve(device)
    report = LoopReport()
    state = steps_mod.init_train_state(cfg, seed, device=dev)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = int(state.step)
        report.resumed_from = start_step

    stop = {"flag": False}

    def _handler(signum, frame):
        stop["flag"] = True

    old_term = signal.signal(signal.SIGTERM, _handler)
    old_int = signal.signal(signal.SIGINT, _handler)

    times: list[float] = []
    try:
        for step in range(start_step, loop.total_steps):
            host = loader.batch_for_step(step)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in host.items()}
            t0 = time.time()
            state, metrics = steps_mod.train_step(state, batch, cfg,
                                                  lr=loop.lr)
            loss = float(metrics["loss"])  # also waits for the step
            dt = time.time() - t0
            times.append(dt)
            if len(times) > loop.straggler_window:
                times.pop(0)
            med = float(np.median(times))
            if len(times) >= 8 and dt > loop.straggler_factor * med:
                report.straggler_steps += 1
            report.steps_run += 1
            report.losses.append(loss)
            report.step_times.append(dt)
            if curator is not None:
                curator.observe_batch(
                    host["example_ids"],
                    metrics["per_example_nll"].cpu().numpy(),
                    host["tokens"])
            if on_metrics and step % loop.log_every == 0:
                on_metrics(step, {"loss": loss, "step_time": dt,
                                  "median_step_time": med})
            if ckpt is not None and (step + 1) % loop.ckpt_every == 0:
                ckpt.save(state, step + 1, metric=loss)
            if stop["flag"]:
                report.interrupted = True
                break
        if ckpt is not None:
            ckpt.save(state, int(state.step), metric=report.losses[-1]
                      if report.losses else float("nan"), blocking=True)
            ckpt.wait()
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    report.final_state = state
    return report
