"""Fleet-axis sharding: the M (stream) dimension split across shards —
the port of the reference's ``parallel.fleet``.

The paper's tiering laws are per stream, so every hot-path array —
reservoir state, drift statistics, cost ledgers, planner inputs — is
embarrassingly parallel along its leading M axis. The reference lays
that axis over a 1-D JAX ``Mesh`` and ``shard_map``s one program over
it. The port keeps the reference's single controller: one process
drives a ``FleetMesh``, a tuple of ``torch.device``s with one entry per
shard (a device may repeat, so several shards can share one card, the
counterpart of the reference's forced host devices). A shard's rows live
in their own tensors on their shard's device, and each shard runs the
unsharded program on its rows, one shard after another on its device's
current stream. There is no ``torch.distributed`` here: the host meter,
the router and the monitors are one per fleet.

Rows are split as the reference splits them: ``pad_rows(m, D)`` rows in
D contiguous blocks, the padding rows inert (``(-inf, -1, seen=0)``
reservoirs, all-pad batches), and host reads slice them off. Every
update is row-independent, so sharded outputs are bit-identical to the
unsharded run at every fleet size (the tests assert it).

The one genuinely cross-shard computation is fleet-shared capacity
water-filling (``waterfill_sharded``), whose water level λ couples every
stream: a bisection whose per-shard partial sums are added on shard 0's
device, the counterpart of the reference's ``psum``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

FLEET_AXIS = "fleet"
_STATE = threading.local()


@dataclass(frozen=True)
class FleetMesh:
    """The shards of a fleet: one ``torch.device`` a shard, in shard
    order (shard d holds the d-th block of every bucket's rows)."""

    devices: Tuple[torch.device, ...]

    axis_names = (FLEET_AXIS,)

    @property
    def shape(self) -> dict:
        return {FLEET_AXIS: len(self.devices)}


def _normal(device) -> torch.device:
    """``device`` with a CUDA index filled in (``"cuda"`` names the
    current card), so equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def fleet_mesh(devices: Optional[int] = None, *,
               device=None) -> Optional[FleetMesh]:
    """A fleet mesh of ``devices`` shards. Without ``device`` the shards
    are the first ``devices`` visible CUDA cards (all of them when None),
    and asking for more than are visible raises. With ``device`` (one
    device, or a list of one a shard) every shard goes there: that is how
    n shards share one card, or the CPU. Returns ``None`` below 2 shards
    — the callers then keep their unsharded paths."""
    if device is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        d = avail if devices is None else int(devices)
        if d > avail:
            raise ValueError(
                f"fleet mesh needs {d} devices, only {avail} CUDA devices "
                "are visible — pass device= to put several shards on one "
                "device")
        devs = tuple(torch.device("cuda", i) for i in range(d))
    elif isinstance(device, (list, tuple)):
        devs = tuple(_normal(x) for x in device)
        if devices is not None and int(devices) != len(devs):
            raise ValueError(f"{devices} shards but {len(devs)} devices")
    else:
        if devices is None:
            raise ValueError("device= needs the number of shards")
        devs = (_normal(device),) * int(devices)
    if len(devs) < 2:
        return None
    return FleetMesh(devs)


def n_shards(mesh: Optional[FleetMesh]) -> int:
    """Fleet-axis size of ``mesh`` (1 for None)."""
    return 1 if mesh is None else len(mesh.devices)


def set_fleet_mesh(mesh: Optional[FleetMesh]) -> None:
    _STATE.mesh = mesh


def get_fleet_mesh() -> Optional[FleetMesh]:
    """The thread-local active fleet mesh (None = unsharded paths).
    ``core.shp_device`` and ``online.replan_device`` consult it to solve
    per shard without any signature plumbing."""
    return getattr(_STATE, "mesh", None)


class use_fleet_mesh:
    """``with use_fleet_mesh(mesh): ...`` — scoped active fleet mesh."""

    def __init__(self, mesh: Optional[FleetMesh]):
        self.mesh = mesh

    def __enter__(self):
        self.prev = get_fleet_mesh()
        set_fleet_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_fleet_mesh(self.prev)


# ---------------------------------------------------------------------------
# Row (leading-M-axis) sharding helpers
# ---------------------------------------------------------------------------

def pad_rows(m: int, shards: int) -> int:
    """Smallest multiple of ``shards`` >= m (>= shards, so every shard
    owns at least one row)."""
    return max(-(-int(m) // shards), 1) * shards


def row_blocks(m: int, shards: int) -> List[Tuple[int, int]]:
    """Each shard's [lo, hi) of the m real rows (pad rows cut; a shard
    past the fleet's end gets an empty block)."""
    per = pad_rows(m, shards) // shards
    return [(min(d * per, m), min((d + 1) * per, m)) for d in range(shards)]


def shard_rows(mesh: Optional[FleetMesh], tree) -> list:
    """Split a tree (a tensor, or a NamedTuple of tensors) row-wise into
    one tree a shard, each leaf a copy of the shard's contiguous block on
    the shard's device. Leading dims must be multiples of the shard count
    — pad with inert rows first. Without a mesh, ``[tree]``."""
    if mesh is None:
        return [tree]
    shards = n_shards(mesh)
    leaves = [tree] if isinstance(tree, torch.Tensor) else list(tree)
    for leaf in leaves:
        if leaf.shape[0] % shards:
            raise ValueError(f"leading dim {leaf.shape[0]} is not a "
                             f"multiple of {shards} shards")
    out = []
    for d, dev in enumerate(mesh.devices):
        part = []
        for leaf in leaves:
            per = leaf.shape[0] // shards
            part.append(leaf[d * per:(d + 1) * per].to(dev, copy=True))
        out.append(part[0] if isinstance(tree, torch.Tensor)
                   else type(tree)(*part))
    return out


def gather_rows(parts: Sequence, m: Optional[int] = None):
    """Inverse of ``shard_rows``: concatenate the shards' trees on shard
    0's device and cut the result to its first ``m`` rows (the
    padding)."""
    first = parts[0]
    dev = first.device if isinstance(first, torch.Tensor) else first[0].device

    def cat(leaves):
        out = torch.cat([x.to(dev) for x in leaves])
        return out if m is None else out[:m]

    if isinstance(first, torch.Tensor):
        return cat(parts)
    return type(first)(*(cat(leaves) for leaves in zip(*parts)))


# ---------------------------------------------------------------------------
# Cross-shard fleet-shared capacity water-filling
# ---------------------------------------------------------------------------

_WF_ITERS = 96  # f64 bisection: hi/2^96 is far below one ulp of λ


def _fleet_sum(values: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """Per-shard 0-d partial sums added on ``device`` in shard order —
    the port's ``psum``."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


def waterfill_sharded(desired, budget: float,
                      mesh: FleetMesh) -> np.ndarray:
    """Device-resident ``streams.planner.waterfill`` for a sharded fleet:
    each stream's desired occupancy stays on its own shard, and the
    common water level λ (Σ min(desired, λ) = budget) is found by a
    96-step float64 bisection whose grant sums are computed per shard
    and added on shard 0's device — no value is read back to the host
    inside the loop.

    Returns the (M,) grants. Bisecting from below keeps the invariant
    Σ min(d, lo) <= budget, so the fleet never oversubscribes ``budget``
    (up to the cross-shard sum's own rounding, ~1 ulp); when the desires
    already fit they are granted verbatim."""
    d = np.asarray(desired, np.float64).reshape(-1)
    m = d.shape[0]
    shards = n_shards(mesh)
    dp = np.zeros(pad_rows(m, shards), np.float64)
    dp[:m] = d  # zero-desire pad rows draw no grant at any λ
    parts = shard_rows(mesh, torch.from_numpy(dp))
    home = mesh.devices[0]
    f64 = torch.float64
    zero = torch.zeros((), dtype=f64, device=home)
    budget_t = torch.tensor(float(budget), dtype=f64, device=home)
    total = _fleet_sum([p.sum() for p in parts], home)
    hi = zero
    for p in parts:  # the pmax of the shards' maxima
        hi = torch.maximum(hi, p.max().to(home))
    lo = zero
    for _ in range(_WF_ITERS):
        mid = 0.5 * (lo + hi)
        s = _fleet_sum([torch.minimum(p, mid.to(p.device)).sum()
                        for p in parts], home)
        ok = s <= budget_t
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    level = torch.maximum(lo, zero)
    fits = total <= budget_t
    grants = [torch.where(fits.to(p.device), p,
                          torch.minimum(p, level.to(p.device)))
              for p in parts]
    return np.concatenate([g.cpu().numpy() for g in grants])[:m]
