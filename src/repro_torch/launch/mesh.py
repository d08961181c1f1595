"""Production mesh definitions — the port of the reference's
``launch.mesh``.

The meshes are logical (``parallel.ctx.LogicalMesh``: axis names and
sizes, no devices), so building one touches no device state. Single pod =
16×16 = 256 chips; multi-pod adds a leading ``pod`` axis (2 × 256 = 512
chips). The dry run prices a cell on them per chip.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.ctx import LogicalMesh


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> LogicalMesh:
    """Small mesh clipped to the local devices, as the reference clips to
    ``jax.devices()``: the CUDA cards when there are any, else the one
    CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return LogicalMesh((data, model), ("data", "model"))
