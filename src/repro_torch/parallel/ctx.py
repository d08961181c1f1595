"""Logical mesh context and the marker → axes rules — the port of the
reference's ``parallel.ctx``.

The reference's models call ``shard(x, BATCH, None, MODEL, ...)`` with
logical markers, which resolve to mesh axes where a dimension divides the
axis size (so 8 KV heads on a 16-way model axis fall back to replicated
instead of failing to lower), and its dry run shards parameters, batches
and caches by the same rules. The port keeps the rules and the markers.
Its mesh is ``LogicalMesh``: axis names and sizes, no devices — the port
runs each model whole on one card, and nothing here partitions a program.
The dry run (``launch.dryrun``) uses the rules to price a cell per chip.

A spec is a plain tuple, the counterpart of ``PartitionSpec``: one entry
per dimension, ``None``, an axis name or a tuple of names.

``shard`` and ``named`` are not ported: without an SPMD partitioner no
constraint has anything to steer, and the port's models call no
``shard`` (a divergence kept on purpose; ROADMAP, queue 3).
"""
from __future__ import annotations

import math
import threading
from typing import Mapping, Optional

BATCH = "@batch"   # data-parallel axes: ('pod','data') when present
MODEL = "@model"   # tensor-parallel axis
SEQ = "@seq"       # sequence-parallel: ('data','model') — long-context B=1
_STATE = threading.local()


class LogicalMesh:
    """A mesh of named axes and their sizes, with no devices: the
    counterpart of ``jax.sharding.Mesh`` / ``AbstractMesh`` for the
    rules."""

    def __init__(self, shape: Mapping[str, int] | tuple, axis_names=None):
        if axis_names is not None:
            shape = dict(zip(axis_names, shape, strict=True))
        self.shape = {str(a): int(n) for a, n in dict(shape).items()}
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def set_mesh(mesh: Optional[LogicalMesh]):
    _STATE.mesh = mesh


def get_mesh() -> Optional[LogicalMesh]:
    return getattr(_STATE, "mesh", None)


class use_mesh:
    def __init__(self, mesh: LogicalMesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self.prev)


def dp_axes(mesh: LogicalMesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tp_size() -> int:
    """Size of the tensor-parallel axis of the active mesh (1 if none)."""
    mesh = get_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


def axis_size(mesh: LogicalMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= mesh.shape[a]
    return s


def resolve(mesh: LogicalMesh, marker, dim_size: int):
    """Marker → concrete mesh axes (or None if indivisible/absent)."""
    if marker is None:
        return None
    if marker == BATCH:
        axes = dp_axes(mesh)
    elif marker == MODEL:
        axes = ("model",) if "model" in mesh.axis_names else ()
    elif marker == SEQ:
        axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    else:  # explicit axis name(s)
        axes = (marker,) if isinstance(marker, str) else tuple(marker)
        axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    if dim_size % axis_size(mesh, axes) != 0:
        # try a shrinking prefix (e.g. B=16 on pod×data=32 → data only)
        for cut in range(len(axes) - 1, 0, -1):
            if dim_size % axis_size(mesh, axes[:cut]) == 0:
                return axes[:cut] if len(axes[:cut]) > 1 else axes[0]
        return None
    return axes if len(axes) > 1 else axes[0]


def spec(mesh: LogicalMesh, markers, shape) -> tuple:
    """The spec of a ``shape`` under ``markers``: one entry per
    dimension; an axis appears at most once, a later dimension that
    would reuse one stays replicated."""
    entries = []
    used: set = set()
    for marker, dim in zip(markers, shape):
        r = resolve(mesh, marker, dim)
        raxes = (r,) if isinstance(r, str) else (r or ())
        if r is not None and not (set(raxes) & used):
            used.update(raxes)
            entries.append(r)
        else:
            entries.append(None)
    return tuple(entries)
