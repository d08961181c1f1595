"""Batched multi-tenant top-K stream engine on torch tensors — the port of
the reference's ``streams.engine``, exact backend, one device.

One step advances M concurrent reservoirs at once: state carries a
leading stream axis (``BatchedReservoirState``) and the update is the
torch reservoir of ``core.topk`` applied row-wise, so per-stream semantics
— lower-id tie-break, id dedupe, write mask — equal M independent
single-stream replays. Wide batches (W >= K) are pre-filtered by the fleet
bar scan ``kernels.batched_topk`` before the exact merge; the finalize
step maps survivors to tiers with ``kernels.tier_assign``. Which version
of a kernel runs follows the tensors' device: the CUDA kernel on the card,
its plain PyTorch version on the CPU. There is no switch.

Heterogeneous fleets (per-stream K) are bucketed by (K, backend)
(``streams.router``); ``StreamEngine`` plans placement for the whole fleet
on the host (``streams.planner``), runs every bucket in each step and
meters every transaction per stream (``streams.metering``). Huge-K
tenants can take the O(log K) ``engine="logmem"`` threshold tracker
(``streams.logmem``, admission scan ``kernels.logmem_update``) per
``StreamSpec``; both backends mix in one fleet step.

Online re-planning (``replan=`` a ``online.ReplanConfig``): each step
also advances every bucket's drift detector (``online.drift``) from the
chunk's write counts on the device; between chunks the streams whose
detector fired are re-solved over the rest of their window
(``online.replan``; on the card through ``online.replan_device`` and the
``plan_solve`` kernel) and the new boundaries are applied to the meter.

Observability (``obs=`` a ``obs.Observability``): the step also folds
the device counters (``obs.metrics``) and, with ``ObsConfig(costs=True)``,
each bucket's cost ledger (``obs.costs``) — tensor reductions on the
engine's device with no read back to the host; between chunks the host
monitors (``obs.residuals.ResidualMonitor``, ``obs.costs.CostMonitor``)
test the meter's drain and may add their alerted streams to the
re-planner's; spans and events land on the tracer.

Resilience (``repro_torch.resilience``): ``chunks_ingested`` is the ingest
cursor, and a checkpointer attached with ``attach_checkpointer`` runs at
every chunk boundary. ``tier_outage`` / ``tier_recover`` mask a failed
storage tier out of every re-plan and evacuate the streams that use it.

Fleet-axis sharding (``mesh=`` a ``parallel.fleet.FleetMesh`` of D >= 2
shards): every bucket pads its rows to a multiple of D with inert rows
and keeps each shard's contiguous block in its own tensors on the
shard's device — reservoir or logmem state, drift state, cost ledger —
and each shard's metrics block. A step runs ``step`` once a shard over
its rows, so every kernel launches once a shard and bucket; the plan and
the re-solves run per shard under the mesh; host reads cut the padding.
Outputs are bit-identical to the unsharded engine's.
"""
from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import topk
from repro_torch.core.costs import NTierCostModel, TwoTierCostModel
from repro_torch.kernels.batched_topk import ops as btk_ops
from repro_torch.kernels.tier_assign import ops as ta_ops
from repro_torch.parallel import fleet

from . import logmem, metering, planner, router

PAD_ID = router.PAD_ID


class BatchedReservoirState(NamedTuple):
    """M reservoirs stacked on a leading stream axis."""

    scores: torch.Tensor  # (M, K) float32, each row sorted desc, -inf padded
    ids: torch.Tensor  # (M, K) int32 per-stream local doc index, -1 padded
    seen: torch.Tensor  # (M,) int32 — docs observed per stream (no padding)


def init(m: int, k: int, device=None) -> BatchedReservoirState:
    """M empty reservoirs of width k on ``device`` (the CUDA card unless
    given)."""
    dev = device_mod.resolve(device)
    return BatchedReservoirState(
        scores=torch.full((m, k), float("-inf"), dtype=torch.float32,
                          device=dev),
        ids=torch.full((m, k), -1, dtype=torch.int32, device=dev),
        seen=torch.zeros((m,), dtype=torch.int32, device=dev),
    )


def state_from_numpy(scores, ids, seen, device=None) -> BatchedReservoirState:
    """The port's state from a reference ``BatchedReservoirState`` given as
    numpy arrays (scores (M, K) f32, ids (M, K) i32, seen (M,) i32)."""
    dev = device_mod.resolve(device)
    return BatchedReservoirState(
        scores=torch.tensor(np.asarray(scores, np.float32), device=dev),
        ids=torch.tensor(np.asarray(ids, np.int32), device=dev),
        seen=torch.tensor(np.asarray(seen, np.int32), device=dev),
    )


def state_to_numpy(state: BatchedReservoirState
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of ``state_from_numpy``: (scores, ids, seen) numpy arrays."""
    return (state.scores.cpu().numpy(), state.ids.cpu().numpy(),
            state.seen.cpu().numpy())


def _with_seen(new: topk.ReservoirState, state: BatchedReservoirState,
               batch_ids: torch.Tensor) -> BatchedReservoirState:
    seen = state.seen + (batch_ids >= 0).sum(dim=1, dtype=torch.int32)
    return BatchedReservoirState(new.scores, new.ids, seen)


def update(state: BatchedReservoirState, batch_scores: torch.Tensor,
           batch_ids: torch.Tensor
           ) -> Tuple[BatchedReservoirState, torch.Tensor]:
    """Fused update of all M streams: scores/ids (M, W), padding =
    (-inf, -1). Returns (new_state, wrote (M, W) bool). Padding never
    writes and does not advance ``seen``."""
    new, wrote = topk.update(state, batch_scores, batch_ids)
    return _with_seen(new, state, batch_ids), wrote


def filtered_update(state: BatchedReservoirState, batch_scores: torch.Tensor,
                    batch_ids: torch.Tensor
                    ) -> Tuple[BatchedReservoirState, torch.Tensor]:
    """Update for wide ingest batches: one fleet bar scan
    (``kernels.batched_topk``) of every stream's candidates against its
    reservoir bar, then an exact merge over at most K survivors per
    stream. Equal to ``update`` when per-stream doc ids arrive in
    increasing order (the stream case)."""
    k = state.scores.shape[1]
    w = batch_scores.shape[1]
    batch_scores = batch_scores.to(torch.float32).contiguous()
    batch_ids = batch_ids.to(torch.int32)
    bar = state.scores[:, -1].contiguous()
    mask, _, _ = btk_ops.batched_topk_filter(batch_scores, bar)
    # re-observed resident ids are dropped by the merge anyway; mask them
    # out before the survivor cut so they cannot take a survivor slot
    # that a fresh candidate (which plain ``update`` admits) should get
    resident = topk.member(batch_ids, state.ids)
    keep = (mask > 0) & ~resident
    surv = torch.where(keep, batch_scores, float("-inf"))
    top_idx = topk.top_k_positions(surv, min(k, w))
    top_scores = torch.gather(surv, 1, top_idx)
    top_ids = torch.gather(batch_ids, 1, top_idx)
    top_ids = torch.where(torch.isfinite(top_scores), top_ids, PAD_ID)
    new, wrote_top = topk.update(state, top_scores, top_ids)
    # scatter the survivors' write mask back to batch positions
    wrote = torch.zeros(batch_scores.shape, dtype=torch.bool,
                        device=batch_scores.device)
    wrote.scatter_(1, top_idx, wrote_top)
    wrote &= batch_ids >= 0
    return _with_seen(new, state, batch_ids), wrote


def merge(a: BatchedReservoirState,
          b: BatchedReservoirState) -> BatchedReservoirState:
    """Row-wise cross-shard reduction (see ``topk.merge``)."""
    new = topk.merge(a, b)
    return BatchedReservoirState(new.scores, new.ids, a.seen + b.seen)


def thresholds(state: BatchedReservoirState) -> torch.Tensor:
    """(M,) current per-stream entry bars (-inf while unfull)."""
    return state.scores[:, -1]


def placements(state: BatchedReservoirState, r) -> torch.Tensor:
    """Per-slot tier with per-stream changeovers: ``r`` is (M,) scalar
    boundaries (the two-tier case, via ``topk.tier_of``) or (M, B)
    boundary vectors (tier = number of boundaries <= id). -1 = empty.
    Float boundaries compare in float32, as in the reference."""
    r = torch.as_tensor(r, device=state.ids.device)
    r = r.to(torch.float32 if r.is_floating_point() else torch.int32)
    if r.dim() <= 1:
        t = topk.tier_of(state.ids, r.reshape(-1, 1))
    else:
        t = (state.ids[:, :, None] >= r[:, None, :]).sum(-1,
                                                         dtype=torch.int32)
    return torch.where(state.ids >= 0, t, -1)


def evicted_ids(old: BatchedReservoirState,
                new: BatchedReservoirState) -> torch.Tensor:
    """(M, K) local doc ids evicted by the step (-1 = none) — the storage
    the fleet can free (paper §VI)."""
    return torch.where(topk.evicted(old, new), old.ids, PAD_ID)


def step(states: Sequence, batches, buckets: Sequence[router.Bucket],
         dstates: Sequence = (), drift_cfg=None, mstate=None,
         cstates: Optional[Sequence] = None):
    """One fleet step over all buckets: ``batches`` holds one (scores,
    ids) (M_b, W) pair per bucket, ``buckets`` the router's buckets (K
    and backend). Returns (new_states, wrotes, evicted, new_dstates,
    mstate, new_cstates): lists with one entry per bucket
    (``new_dstates`` empty without ``drift_cfg``, ``new_cstates`` without
    ``cstates``) and the new metrics state (None without ``mstate``).

    With ``drift_cfg`` (online re-planning) the step also advances each
    bucket's drift-detector state ``dstates[b]`` from the chunk's write
    counts, after the bucket's merge; logmem buckets test their evidence
    with the backend's ``law_slack`` folded into the thresholds.

    With ``mstate`` (an ``obs.metrics.MetricsState``) the step folds the
    fleet counters, and with ``cstates`` (one ``obs.costs.CostState`` a
    bucket) the cost ledgers: reductions over tensors the step already
    has, none read back to the host. Without them the step runs exactly
    the operations it runs without obs.

    Non-finite scores are quarantined before any compare sees them (NaN
    fails every comparison, ±inf corrupts the entry bar): they become
    inert (-inf, -1) pad slots. Logmem buckets advance through
    ``logmem.update`` and evict nothing ((M_b, 0) evictions); their
    metrics bar is the active threshold ``tau``. Exact buckets with wide
    batches (W >= K) take ``filtered_update``, narrow ones the fused
    sort-merge ``update``, whose one sort is then cheaper."""
    if drift_cfg is not None:
        from repro_torch.online import drift as drift_mod
    if mstate is not None:
        from repro_torch.obs import metrics as metrics_mod
    if cstates is not None:
        from repro_torch.obs import costs as costs_mod
    new_states, wrotes, evs, new_dstates, new_cstates = [], [], [], [], []
    for bi, (st, (s, i), b) in enumerate(zip(states, batches, buckets)):
        bad = (i >= 0) & ~torch.isfinite(s)
        s = torch.where(bad, float("-inf"), s)
        i = torch.where(bad, PAD_ID, i)
        if mstate is not None:
            mstate = metrics_mod.accumulate_quarantine(
                mstate, bad.sum(dtype=torch.int32))
        if b.engine == "logmem":
            new, wrote = logmem.update(st, s, i, b.k)
            ev = torch.full((s.shape[0], 0), PAD_ID, dtype=torch.int32,
                            device=s.device)
            bar = st.tau
            slack = logmem.law_slack(b.k)
            if cstates is not None:
                new_cstates.append(costs_mod.accumulate_logmem(
                    cstates[bi], i, wrote))
        else:
            if s.shape[1] >= st.scores.shape[1]:
                new, wrote = filtered_update(st, s, i)
            else:
                new, wrote = update(st, s, i)
            ev = evicted_ids(st, new)
            bar = st.scores[:, -1]
            slack = 0.0
            if cstates is not None:
                new_cstates.append(costs_mod.accumulate_exact(
                    cstates[bi], i, wrote, ev, new.ids))
        new_states.append(new)
        wrotes.append(wrote)
        evs.append(ev)
        if drift_cfg is not None:
            new_dstates.append(drift_mod.update(
                dstates[bi], wrote.sum(dim=1), new.seen, float(b.k),
                drift_cfg, slack=slack))
        if mstate is not None:
            mstate = metrics_mod.accumulate_bucket(mstate, s, i, bar, wrote,
                                                   ev)
    if mstate is not None:
        if drift_cfg is not None:
            dev = mstate.counts.device
            score_max = torch.zeros((), dtype=torch.float32, device=dev)
            fired = torch.zeros((), dtype=torch.int32, device=dev)
            for ds, b in zip(new_dstates, buckets):
                sl = logmem.law_slack(b.k) if b.engine == "logmem" else 0.0
                score_max = torch.maximum(
                    score_max, drift_mod.scores(ds, drift_cfg, slack=sl).max())
                fired = fired + ds.fired.sum(dtype=torch.int32)
            mstate = metrics_mod.accumulate_drift(mstate, score_max, fired)
        mstate = metrics_mod.bump_chunk(mstate)
    return new_states, wrotes, evs, new_dstates, mstate, new_cstates


# ---------------------------------------------------------------------------
# Fleet orchestration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReplanEvent:
    """One online re-planning decision (``StreamEngine.replan_events``)."""

    stream_id: int
    row: int
    position: int  # docs the stream had observed at decision time
    rho: float  # detector's rate-multiplier estimate
    old_bounds: Tuple[float, ...]
    new_bounds: Tuple[float, ...]
    applied: bool
    feasible: bool  # constrained suffix re-solve found a feasible plan
    suffix_cost_old: float
    suffix_cost_new: float
    move_bill: float  # expected relocation cost priced into the decision
    moved_docs: int  # residents actually re-tiered by the meter


@dataclass(frozen=True)
class AdmissionEvent:
    """Advisory terms for a stream whose constrained suffix re-solve was
    infeasible (``StreamEngine.admission_events``): the negotiated K /
    window apply at the tenant's next window — a live reservoir row
    cannot be resized mid-window."""

    stream_id: int
    row: int
    position: int
    decision: object  # online.admission.AdmissionDecision


@dataclass(frozen=True)
class StreamSpec:
    """One tenant stream: its K, and either an explicit placement — a
    changeover index ``r`` (two-tier) or a ``boundaries`` vector (N-tier),
    with ``migrate`` choosing Algorithm C's cascade at the boundaries — or
    a cost model (two-tier or N-tier topology) for the proactive planner
    to derive both. Streams of different tier depths mix freely in one
    fleet. ``engine`` is the reservoir backend: ``"exact"`` keeps the
    (K,) score/id rows, ``"logmem"`` O(log K) state (``streams.logmem``;
    huge-K tenants) at a 1 − O(1/√K) admission slack, with static
    boundaries only."""

    stream_id: int
    k: int
    cost_model: Optional[TwoTierCostModel | NTierCostModel] = None
    r: Optional[float] = None
    migrate: bool = False
    boundaries: Optional[Tuple[float, ...]] = None
    engine: str = "exact"

    def explicit_boundaries(self) -> Optional[Tuple[float, ...]]:
        if self.boundaries is not None:
            return tuple(float(b) for b in self.boundaries)
        return (float(self.r),) if self.r is not None else None


def _ids(state) -> torch.Tensor:
    return state.ids


def _readonly_view(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor on ``a``'s memory, used only as a copy source (so a
    read-only array, e.g. a broadcast view, is fine)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable")
        return torch.from_numpy(a)


class _ChunkStager:
    """Double buffer for ``StreamEngine.ingest_chunks`` on one card (one
    stager a card; shards that share a card share it): two slots, each a
    set of pinned host buffers and device buffers. A chunk
    is copied into a slot's pinned buffers on the host, then to its
    device buffers by an asynchronous copy on a side stream, while the
    compute stream runs the previous chunk's step. Events order the
    streams: the step waits for its slot's copy (``copied``), a copy into
    a slot waits until the step two chunks back has finished reading it
    (``consumed``), and the first copy into new device buffers waits for
    the compute stream. The buffers are reused in place across chunks."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.slots = [{"shapes": None, "pinned": None, "dev": None,
                       "copied": torch.cuda.Event(),
                       "consumed": torch.cuda.Event()} for _ in range(2)]

    def stage(self, slot: int, dense) -> list:
        sl = self.slots[slot]
        sl["copied"].synchronize()  # the slot's pinned buffers are free
        shapes = [(s.shape, i.shape) for s, i in dense]
        if sl["shapes"] != shapes:
            sl["consumed"].synchronize()  # old device buffers are unread
            sl["pinned"] = [
                (torch.empty(s.shape, dtype=torch.float32, pin_memory=True),
                 torch.empty(i.shape, dtype=torch.int32, pin_memory=True))
                for s, i in dense]
            sl["dev"] = [
                (torch.empty(s.shape, dtype=torch.float32,
                             device=self.device),
                 torch.empty(i.shape, dtype=torch.int32, device=self.device))
                for s, i in dense]
            sl["shapes"] = shapes
            # the new device buffers may reuse memory that kernels already
            # queued on the compute stream still touch (the caching
            # allocator orders reuse within one stream only): the copy
            # stream writes them only after that work
            self.copy_stream.wait_stream(torch.cuda.current_stream(
                self.device))
            for ds, di in sl["dev"]:  # and are not reused before its copies
                ds.record_stream(self.copy_stream)
                di.record_stream(self.copy_stream)
        # PyTorch's copy_ spreads the host copy over the intra-op threads
        for (ps, pi), (s, i) in zip(sl["pinned"], dense):
            ps.copy_(_readonly_view(s))
            pi.copy_(_readonly_view(i))
        self.copy_stream.wait_event(sl["consumed"])
        with torch.cuda.stream(self.copy_stream):
            for (ds, di), (ps, pi) in zip(sl["dev"], sl["pinned"]):
                ds.copy_(ps, non_blocking=True)
                di.copy_(pi, non_blocking=True)
        sl["copied"].record(self.copy_stream)
        return sl["dev"]

    def wait(self, slot: int) -> None:
        """The compute stream waits for the slot's copy to land."""
        torch.cuda.current_stream(self.device).wait_event(
            self.slots[slot]["copied"])

    def done(self, slot: int) -> None:
        """Mark the slot read once the compute stream's queued work (the
        step reading it) has run."""
        self.slots[slot]["consumed"].record(
            torch.cuda.current_stream(self.device))


class StreamEngine:
    """Host-side orchestrator: buckets streams by K, plans placement for
    the whole fleet in one vectorized pass, routes mixed ingest batches,
    advances every bucket in one step per chunk on ``device``, and meters
    per-stream ledgers against the analytic expectations.

    Usage::

        engine = StreamEngine(specs)                 # on the CUDA card
        engine.ingest(stream_ids, scores, doc_ids)   # mixed batch, any order
        survivors = engine.finalize()                # {stream_id: top-K ids}
        engine.meter.reconcile(batch=W)              # vs analytic write law

    ``device`` defaults to the CUDA card and is required without one
    (``device="cpu"`` runs the plain PyTorch versions of the kernels).

    ``replan`` (an ``online.ReplanConfig``) turns on online re-planning;
    its suffix solver is ``online.Replanner``'s "auto" on the engine's
    device: ``online.replan_device`` on a CUDA device, the NumPy loop on
    the CPU.

    ``obs`` (an ``obs.Observability``) turns on the telemetry layer: the
    device counters and cost ledgers in the step, the residual and cost
    monitors between chunks (whose alerts join the re-plan trigger under
    ``ObsConfig.residual_trigger`` / ``cost_trigger``), and the span and
    event timeline; ``obs_snapshot``, ``cost_summary``, ``cost_alerts``
    and ``residual_alerts`` read them.

    ``mesh`` (a ``parallel.fleet.FleetMesh``) shards the fleet axis: the
    shards' devices come from the mesh (``device``, when given, must be
    of the same type), ``device`` is shard 0's, and a 1-shard mesh is
    the unsharded engine.
    """

    def __init__(self, specs: Sequence[StreamSpec], *, constraints=None,
                 device=None, replan=None, obs=None, mesh=None):
        if mesh is not None and fleet.n_shards(mesh) < 2:
            mesh = None
        self.mesh = mesh
        self._shards = fleet.n_shards(mesh)
        if mesh is None:
            self.device = device_mod.resolve(device)
            self._devices = (self.device,)
        else:
            self._devices = tuple(mesh.devices)
            self.device = self._devices[0]
            if device is not None and \
                    torch.device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device.type} devices")
        if not specs:
            raise ValueError("need at least one stream")
        by_id = {s.stream_id: s for s in specs}
        if len(by_id) != len(specs):
            raise ValueError("duplicate stream ids")
        for s in specs:
            if s.engine not in ("exact", "logmem"):
                raise ValueError(f"stream {s.stream_id}: unknown engine "
                                 f"{s.engine!r} (exact|logmem)")
            if s.engine == "logmem" and s.migrate:
                raise ValueError(
                    f"stream {s.stream_id}: engine='logmem' stores no "
                    "resident ids — the migration cascade needs the exact "
                    "backend")
        self.buckets = router.bucket_streams(
            {s.stream_id: s.k for s in specs},
            {s.stream_id: s.engine for s in specs})
        self.router = router.StreamRouter(self.buckets)
        self.constraints = constraints
        # observability (repro_torch.obs): device counters in the step,
        # residual and cost alert channels off the meter drain, the
        # span/event timeline
        self._obs = obs
        self._tracer = obs.tracer if obs is not None else None
        if obs is not None:
            obs.attach(self)
        # fleet plan for streams that carry a cost model (2- and N-tier mix)
        planned = [s for s in specs if s.explicit_boundaries() is None]
        if planned:
            if any(s.cost_model is None for s in planned):
                raise ValueError(
                    "each stream needs r, boundaries, or a cost_model")
            with self._span("plan", streams=len(planned)):
                plan = planner.plan_fleet_mixed(
                    [s.cost_model for s in planned],
                    constraints=constraints, mesh=mesh, device=self.device)
            bad = [s.stream_id for i, s in enumerate(planned)
                   if not plan.feasible(i)]
            if bad:
                raise ValueError(
                    f"streams {bad} have no feasible plan under the given "
                    "constraints — relax capacities/SLO or drop the streams")
            b_of = {s.stream_id: plan.boundaries[i]
                    for i, s in enumerate(planned)}
            mig_of = {s.stream_id: plan.migrate(i)
                      for i, s in enumerate(planned)}
            self.plan: Optional[planner.MixedFleetPlan] = plan
        else:
            b_of, mig_of = {}, {}
            self.plan = None
        # global row order = bucket order × row order (the meter's layout)
        self._global_rows: List[np.ndarray] = []
        ks, bounds, migs, logmems = [], [], [], []
        offset = 0
        self._row_of: Dict[int, int] = {}
        self._model_of_row: Dict[int, object] = {}
        for b in self.buckets:
            self._global_rows.append(
                np.arange(offset, offset + b.m, dtype=np.int64))
            for j, sid in enumerate(b.stream_ids):
                self._row_of[sid] = offset + j
                spec = by_id[sid]
                if spec.cost_model is not None:
                    self._model_of_row[offset + j] = spec.cost_model
                ks.append(spec.k)
                logmems.append(spec.engine == "logmem")
                explicit = spec.explicit_boundaries()
                if explicit is not None:
                    bounds.append(explicit)
                    migs.append(spec.migrate)
                else:
                    bounds.append(b_of[sid])
                    # planner-derived cascades need resident ids; logmem
                    # tenants take the plan's boundaries statically
                    migs.append(bool(mig_of[sid])
                                and spec.engine == "exact")
            offset += b.m
        self._sid_of_row = {row: sid for sid, row in self._row_of.items()}
        self.meter = metering.FleetMeter(ks, migrate=migs, boundaries=bounds,
                                         logmem=logmems)
        # sharded buckets pad their rows to a multiple of the shard count
        # (pad rows are inert under every law; host reads cut them) and
        # hold each shard's contiguous block in its own tensors: every
        # per-bucket device state below is then a list of one state a
        # shard, and the unsharded engine's is the state itself
        self._pad_m = [fleet.pad_rows(b.m, self._shards) if mesh else b.m
                       for b in self.buckets]
        self._blocks = [fleet.row_blocks(b.m, self._shards)
                        for b in self.buckets]
        self._states: List = [self._new_rows(bi, self._make_state)
                              for bi in range(len(self.buckets))]
        # quantize the planned boundaries for tier_assign and move them to
        # the device once; a re-plan marks its buckets stale and
        # assign_tiers re-quantizes those; logmem buckets have no
        # survivors to assign
        self._bounds_int = [
            None if b.engine == "logmem" else self._quantized_bounds(bi)
            for bi, b in enumerate(self.buckets)]
        self._bounds_stale = set()
        # online re-planning: drift detector inside the step, boundary
        # deltas applied between chunks (repro_torch.online)
        self.replan_config = replan
        self.replan_events: List[ReplanEvent] = []
        self.admission_events: List[AdmissionEvent] = []
        self._drift_states = None
        self._replanner = None
        if replan is not None:
            from repro_torch.online import drift as drift_mod
            from repro_torch.online.replan import Replanner
            cset_arg = constraints
            if isinstance(constraints, (list, tuple)):
                # per-spec constraint lists align with the specs sequence;
                # the replanner indexes by global row
                by_sid = {s.stream_id: c
                          for s, c in zip(specs, constraints)}
                cset_arg = [by_sid[self._sid_of_row[row]]
                            for row in range(self.m)]
            self._replanner = Replanner(
                [self._model_of_row.get(row) for row in range(self.m)],
                constraints=cset_arg, config=replan, device=self.device)
            self._drift_states = [self._new_rows(bi, self._make_drift)
                                  for bi in range(len(self.buckets))]
        self._metrics_state = None
        self._residuals = None
        self._cost_states = None
        self._cost_monitor = None
        self._pricing = None
        if obs is not None:
            slack_rows = np.where(
                self.meter.logmem,
                np.array([logmem.law_slack(int(k)) for k in self.meter.ks]),
                0.0)
            if obs.config.metrics:
                from repro_torch.obs import metrics as metrics_mod
                if mesh is None:
                    self._metrics_state = metrics_mod.init(
                        device=self.device)
                else:
                    # one counter block a shard, on its device
                    self._set_metrics(metrics_mod.init(
                        device="cpu", shards=self._shards))
            if obs.config.residuals:
                from repro_torch.obs.residuals import ResidualMonitor
                self._residuals = ResidualMonitor(
                    self.meter.ks, alpha=obs.config.residual_alpha,
                    max_checks=obs.config.residual_max_checks,
                    law_slack=slack_rows)
            if obs.config.costs:
                # live cost attribution (obs.costs): the device ledger in
                # the step, the host CostMonitor (cost residuals and
                # budget burn rate) off the meter drain
                from repro_torch.obs import costs as costs_mod
                self._cost_states = [self._new_rows(bi, self._make_costs)
                                     for bi in range(len(self.buckets))]
                self._pricing = costs_mod.stream_pricing(self)
                self._cost_monitor = costs_mod.CostMonitor(
                    self.meter.ks, self.meter.boundaries,
                    self._pricing["cw"], self._pricing["step_rate"],
                    alpha=obs.config.cost_alpha,
                    max_checks=obs.config.cost_max_checks,
                    law_slack=slack_rows, logmem=self.meter.logmem,
                    budget_factor=obs.config.budget_factor,
                    burn_windows=obs.config.burn_windows)
        # resilience (repro_torch.resilience): the ingest cursor is the
        # chunk sequence number — checkpoint step, and the idempotent
        # redelivery guard's high-water mark; a checkpointer attached via
        # ``attach_checkpointer`` is invoked at every chunk boundary
        self.chunks_ingested = 0
        self._checkpoint = None
        # tier-outage bookkeeping: failed tiers are masked out of the
        # re-planner's feasible set; a recovered tier stays masked for a
        # hysteresis window (flap damping) before plans may use it again
        self._failed_tiers: Dict[int, int] = {}
        self._recovering_tiers: Dict[int, int] = {}
        self._tier_outages = 0

    def _span(self, name: str, **attrs):
        """The tracer's span when obs is on, else a no-op context."""
        if self._tracer is None:
            return contextlib.nullcontext()
        return self._tracer.span(name, **attrs)

    @property
    def m(self) -> int:
        return sum(b.m for b in self.buckets)

    # ---- the shard layout ------------------------------------------------

    def _make_state(self, bi: int, rows: int, device) -> object:
        b = self.buckets[bi]
        return (logmem.init(rows, device=device) if b.engine == "logmem"
                else init(rows, b.k, device=device))

    def _make_drift(self, bi: int, rows: int, device) -> object:
        from repro_torch.online import drift as drift_mod
        return drift_mod.init(rows, device=device)

    def _make_costs(self, bi: int, rows: int, device) -> object:
        from repro_torch.obs import costs as costs_mod
        return costs_mod.init_bucket(
            rows, self.meter.boundaries[self._global_rows[bi]],
            self.meter.n_tiers, device=device)

    def _new_rows(self, bi: int, make):
        """A bucket's fresh per-row state from ``make(bi, rows, device)``:
        on the engine's device, or built at the padded row count on the
        host and split over the shards."""
        if self.mesh is None:
            return make(bi, self.buckets[bi].m, self.device)
        return self._place(make(bi, self._pad_m[bi], torch.device("cpu")))

    def _place(self, tree):
        """A host tree of a bucket's (padded) rows in the engine's
        layout: on the device, or one copy of each shard's block on the
        shard's device."""
        if self.mesh is None:
            return type(tree)(*(leaf.to(self.device) for leaf in tree))
        return fleet.shard_rows(self.mesh, tree)

    def _parts(self, x) -> list:
        """The shards' parts of a per-bucket state or tensor (the
        unsharded engine's one part is the state itself)."""
        return list(x) if self.mesh is not None else [x]

    def _wrap(self, parts: list):
        """Inverse of ``_parts``."""
        return parts if self.mesh is not None else parts[0]

    def _host(self, bi: int, x, fn=None) -> np.ndarray:
        """Bucket ``bi``'s rows of ``x`` (a state or tensor, per shard
        under a mesh) on the host, shard padding cut; ``fn`` maps a part
        to the tensor to read. One device read a shard."""
        parts = [p if fn is None else fn(p) for p in self._parts(x)]
        arr = (parts[0].cpu().numpy() if len(parts) == 1 else
               np.concatenate([p.cpu().numpy() for p in parts]))
        return arr[:self.buckets[bi].m]

    def _to_rows(self, bi: int, arr: np.ndarray):
        """A host (m_b, ...) array of bucket ``bi``'s rows as a tensor in
        the engine's layout (pad rows zero: they hold no ids)."""
        if self.mesh is None:
            return torch.tensor(arr, device=self.device)
        out = np.zeros((self._pad_m[bi],) + arr.shape[1:], arr.dtype)
        out[:arr.shape[0]] = arr
        return fleet.shard_rows(self.mesh, torch.from_numpy(out))

    def _locate(self, bi: int, jb: int) -> Tuple[int, int]:
        """(shard, row in the shard) of row ``jb`` of bucket ``bi``."""
        per = self._pad_m[bi] // self._shards
        return jb // per, jb % per

    def _row_reads(self, pick):
        """``read(bi, jb)``: row ``jb`` of bucket ``bi`` of the tensor
        ``pick(bi, shard)``, copied to the host on a (bucket, shard)'s
        first use — one device read per touched shard of a bucket, not
        one per row."""
        cache: Dict[Tuple[int, int], np.ndarray] = {}

        def read(bi: int, jb: int) -> np.ndarray:
            d, r = self._locate(bi, jb)
            if (bi, d) not in cache:
                cache[(bi, d)] = pick(bi, d).cpu().numpy()
            return cache[(bi, d)][r]

        return read

    def _quantized_bounds(self, bi: int):
        return self._to_rows(bi, ta_ops.quantize_boundaries(
            self.meter.boundaries[self._global_rows[bi]]))

    def _metrics_view(self):
        """The metrics state in the reference's layout: flat, or the
        shards' (1, 8) blocks gathered as (D, 8) on shard 0's device."""
        ms = self._metrics_state
        if ms is None or self.mesh is None:
            return ms
        from repro_torch.obs import metrics as metrics_mod
        return fleet.gather_rows([metrics_mod.shard_pack(p) for p in ms])

    def _set_metrics(self, ms) -> None:
        """Install a metrics state in the engine's layout (a sharded
        (D, 8) state splits into one block a shard)."""
        if self.mesh is None:
            self._metrics_state = ms
            return
        from repro_torch.obs import metrics as metrics_mod
        self._metrics_state = [metrics_mod.shard_local(p)
                               for p in fleet.shard_rows(self.mesh, ms)]

    def _set_cost_bounds(self, bi: int, jb: int, bounds_row) -> None:
        """Swap one stream's boundary row in its shard's cost ledger."""
        from repro_torch.obs import costs as costs_mod
        d, r = self._locate(bi, jb)
        parts = self._parts(self._cost_states[bi])
        parts[d] = costs_mod.set_bucket_bounds(parts[d], r, bounds_row)
        self._cost_states[bi] = self._wrap(parts)

    def _reset_drift(self, bi: int, mask: np.ndarray) -> None:
        """Restart the detectors of bucket ``bi``'s rows under ``mask``
        (padded rows), in the shards the mask touches."""
        from repro_torch.online import drift as drift_mod
        parts = self._parts(self._drift_states[bi])
        per = self._pad_m[bi] // self._shards
        for d in range(self._shards):
            md = mask[d * per:(d + 1) * per]
            if md.any():
                parts[d] = drift_mod.reset_where(parts[d],
                                                 torch.from_numpy(md))
        self._drift_states[bi] = self._wrap(parts)

    def _shard_dense(self, dense) -> List[list]:
        """One list of per-bucket host batches a shard: each bucket's
        rows in the shards' blocks, a short last block filled with
        all-pad rows (``router.blank_dense``)."""
        if self.mesh is None:
            return [dense]
        out: List[list] = [[] for _ in range(self._shards)]
        for bi, (s, i) in enumerate(dense):
            per = self._pad_m[bi] // self._shards
            for d, (lo, hi) in enumerate(self._blocks[bi]):
                bs, bd = s[lo:hi], i[lo:hi]
                if hi - lo < per:
                    ps, pi = router.blank_dense(per - (hi - lo), s.shape[1])
                    bs, bd = np.concatenate([bs, ps]), np.concatenate([bd, pi])
                out[d].append((bs, bd))
        return out

    def stream_row(self, stream_id: int) -> int:
        """Global (meter) row of a stream."""
        return self._row_of[stream_id]

    def ingest(self, stream_ids, scores, doc_ids, *,
               pad_to: Optional[int] = None) -> None:
        """Feed a mixed batch of scored docs — (stream_id, score, local doc
        index) triples in arbitrary order — through one fleet step.

        A doc id may appear at most once per stream per batch (they are
        stream positions); the router rejects within-batch duplicates.
        Re-observations across batches are deduped by the merge itself."""
        span = (self._span("ingest", docs=int(len(stream_ids)))
                if self._obs is not None and self._obs.config.trace_ingest
                else contextlib.nullcontext())
        with span:
            self._run_chunk(self.router.route(stream_ids, scores, doc_ids,
                                              pad_to=pad_to))

    def _to_device(self, dense) -> list:
        """Host per-bucket batches as device batches: one list of
        per-bucket (scores, ids) pairs a shard."""
        return [[(torch.tensor(s, device=dev), torch.tensor(i, device=dev))
                 for s, i in part]
                for part, dev in zip(self._shard_dense(dense), self._devices)]

    def _dispatch(self, batches):
        """Run one fleet step on device batches (one per-bucket list a
        shard) and swap in the new states (and drift, metrics and cost
        states): ``step`` once a shard over its rows, on its device. The
        old state tensors return to PyTorch's caching allocator, which
        hands them to the next step: the counterpart of the reference's
        buffer donation."""
        drift_cfg = (self.replan_config.drift
                     if self._drift_states is not None else None)
        outs = []
        for d in range(self._shards):
            def shard(seq, d=d):
                return None if seq is None else [self._parts(x)[d]
                                                 for x in seq]
            mstate = (None if self._metrics_state is None
                      else self._parts(self._metrics_state)[d])
            outs.append(step(
                shard(self._states), batches[d], self.buckets,
                shard(self._drift_states) or (), drift_cfg, mstate,
                shard(self._cost_states)))

        def per_bucket(i):
            return [self._wrap([o[i][bi] for o in outs])
                    for bi in range(len(self.buckets))]

        new_states, wrotes, evs = per_bucket(0), per_bucket(1), per_bucket(2)
        self._states = new_states
        if self._drift_states is not None:
            self._drift_states = per_bucket(3)
        if self._metrics_state is not None:
            self._metrics_state = self._wrap([o[4] for o in outs])
        if self._cost_states is not None:
            self._cost_states = per_bucket(5)
        return wrotes, evs, new_states

    def _consume(self, dense, wrotes, evs, new_states, meter: bool) -> None:
        """Host side of one step: meter the transactions, update the obs
        monitors, maybe re-plan. ``meter=False`` skips all three."""
        if not meter:
            return
        for bi, b in enumerate(self.buckets):
            dense_scores, dense_ids = dense[bi]
            # mirror the device quarantine: docs whose score is
            # non-finite were demoted to pad slots in the step, so the
            # host meter must not count them as observed either
            if not np.isfinite(dense_scores).all():
                dense_ids = np.where(np.isfinite(dense_scores), dense_ids,
                                     router.PAD_ID)
            # logmem buckets have no resident ids: no cascade check, and
            # their (M_b, 0) eviction set scatters nothing; shard padding
            # is cut before the meter sees a row
            st_ids = (None if b.engine == "logmem"
                      else self._host(bi, new_states[bi], _ids))
            self.meter.record_update(
                self._global_rows[bi], dense_ids, self._host(bi, wrotes[bi]),
                self._host(bi, evs[bi]), st_ids)
        residual_rows = ()
        if self._residuals is not None:
            # chunk-boundary drain: the alert channel tests the meter's
            # cumulative write residual against its concentration bound
            newly = self._residuals.update(self.meter.observed,
                                           self.meter.writes.sum(1))
            if newly.any() and self._tracer is not None:
                sc = self._residuals.scores()
                for row in np.flatnonzero(newly):
                    self._tracer.emit(
                        "residual_alert", stream_id=self._sid_of_row[row],
                        row=int(row), position=int(self.meter.observed[row]),
                        score=float(sc[row]),
                        step=int(self._residuals.steps))
            if (self._obs.config.residual_trigger
                    and self._drift_states is not None):
                residual_rows = tuple(
                    int(r) for r in np.flatnonzero(self._residuals.alerted))
        cost_rows = ()
        if self._cost_monitor is not None:
            # the cost channel runs off the same meter drain: realized
            # spend vs the closed-form expected-cost trajectory
            mon = self._cost_monitor
            newly_cost, newly_burn = mon.update(
                self.meter.observed, self.meter.writes, self.meter.doc_steps)
            if self._tracer is not None and newly_cost.any():
                sc = mon.scores()
                for row in np.flatnonzero(newly_cost):
                    self._tracer.emit(
                        "cost_alert", stream_id=self._sid_of_row[row],
                        row=int(row), position=int(self.meter.observed[row]),
                        score=float(sc[row]), step=int(mon.steps))
            if self._tracer is not None and newly_burn.any():
                br = mon.burn_ratio()
                for row in np.flatnonzero(newly_burn):
                    self._tracer.emit(
                        "budget_burn", stream_id=self._sid_of_row[row],
                        row=int(row), position=int(self.meter.observed[row]),
                        burn_ratio=float(br[row]),
                        realized=float(mon.realized_total[row]),
                        planned=float(mon.planned_total[row]),
                        step=int(mon.steps))
            if (self._obs.config.cost_trigger
                    and self._drift_states is not None):
                cost_rows = tuple(int(r) for r in np.flatnonzero(
                    mon.alerted | mon.burn_alerted))
        if self._drift_states is not None:
            self._maybe_replan(residual_rows, cost_rows)

    def _run_chunk(self, dense, *, meter: bool = True) -> None:
        wrotes, evs, new_states = self._dispatch(self._to_device(dense))
        self._consume(dense, wrotes, evs, new_states, meter)
        self._chunk_boundary()

    def _chunk_boundary(self) -> None:
        """Advance the ingest cursor and fire the chunk-boundary
        checkpoint hook (the chunk's states are final here and the next
        chunk has not been dispatched, so a snapshot is consistent)."""
        self.chunks_ingested += 1
        if self._checkpoint is not None:
            self._checkpoint.on_chunk(self)

    def attach_checkpointer(self, checkpointer) -> None:
        """Install a chunk-boundary checkpoint hook (an object with
        ``on_chunk(engine)`` — see ``resilience.FleetCheckpointer``)."""
        if not hasattr(checkpointer, "on_chunk"):
            raise TypeError("checkpointer needs an on_chunk(engine) hook")
        self._checkpoint = checkpointer

    def _checked(self, dense) -> list:
        if len(dense) != len(self.buckets):
            raise ValueError(f"need one (scores, ids) pair per bucket "
                             f"({len(self.buckets)}), got {len(dense)}")
        dense = [(np.asarray(s, np.float32), np.asarray(i, np.int32))
                 for s, i in dense]
        for bi, (s, i) in enumerate(dense):
            if s.shape != i.shape or s.shape[0] != self.buckets[bi].m:
                raise ValueError(
                    f"bucket {bi}: scores {s.shape} / ids {i.shape} do "
                    f"not match the bucket's {self.buckets[bi].m} streams")
        return dense

    def ingest_dense(self, dense, *, meter: bool = True) -> None:
        """Dense per-bucket ingestion, bypassing the host router: one
        ``(scores (M_b, W), doc_ids (M_b, W))`` pair per bucket, aligned
        with ``self.buckets``, rows ordered by doc id and padded with
        ``(-inf, -1)`` — the layout ``router.route`` would produce.

        ``meter=False`` skips the per-stream host ledgers *and* the
        online re-plan hook for this chunk (pure-throughput mode; the
        device states and drift detectors still advance)."""
        self._run_chunk(self._checked(dense), meter=meter)

    def ingest_chunks(self, chunks, *, meter: bool = True) -> int:
        """Double-buffered dense ingestion of an iterable of
        ``ingest_dense``-shaped chunk lists. On the card, chunk t+1 is
        copied host → pinned buffer → device on a side stream while chunk
        t's step runs (see ``_ChunkStager``); the staging buffers are
        reused in place across chunks. Returns the number of chunks."""
        if self.device.type != "cuda":
            count = 0
            for dense in chunks:
                self.ingest_dense(dense, meter=meter)
                count += 1
            return count
        # one stager a card: shards that share a card share its slots
        stagers = {dev: _ChunkStager(dev) for dev in self._devices}
        nb = len(self.buckets)

        def stage(slot, dense):
            shards = self._shard_dense(dense)
            staged = [None] * self._shards
            for dev, stager in stagers.items():
                ds = [d for d, x in enumerate(self._devices) if x == dev]
                flat = stager.stage(slot, [p for d in ds for p in shards[d]])
                for n, d in enumerate(ds):
                    staged[d] = flat[n * nb:(n + 1) * nb]
            return staged

        def run(slot, batches):
            for stager in stagers.values():
                stager.wait(slot)
            out = self._dispatch(batches)
            for stager in stagers.values():
                stager.done(slot)
            return out

        it = iter(chunks)
        nxt = next(it, None)
        slot = 0
        if nxt is not None:
            nxt = self._checked(nxt)
            staged = stage(slot, nxt)
        count = 0
        while nxt is not None:
            dense = nxt
            wrotes, evs, new_states = run(slot, staged)
            nxt = next(it, None)
            slot ^= 1
            if nxt is not None:
                nxt = self._checked(nxt)
                staged = stage(slot, nxt)
            # host consumption blocks on chunk t's outputs last
            self._consume(dense, wrotes, evs, new_states, meter)
            # chunk-boundary checkpoint: chunk t+1 is only staged (its
            # copy on the side stream writes the other slot's buffers),
            # not dispatched, so the snapshot's device→host copies on the
            # compute stream read chunk t's finished states. The
            # reference fires here because its next dispatch donates
            # those states; the port's step donates nothing (it writes
            # every output to new tensors), and the copies complete
            # before the hook returns
            self._chunk_boundary()
            count += 1
        return count

    def _maybe_replan(self, residual_rows: Sequence[int] = (),
                      cost_rows: Sequence[int] = ()) -> None:
        """Between chunks: re-plan the streams whose drift detector fired
        — unioned with the obs residual-alert channel under
        ``ObsConfig.residual_trigger`` and with the cost/budget-burn
        channel under ``ObsConfig.cost_trigger`` — apply the boundary
        deltas to the meter (re-tiering residents, with the relocation
        bill already priced into the decision) and to the cost ledger,
        and reset the consumed detector (and residual/cost) evidence."""
        from repro_torch.online import drift as drift_mod
        fired_rows, rhos = [], []
        bucket_of, row_in_bucket = [], []
        extra = set(residual_rows) | set(cost_rows)
        for bi in range(len(self.buckets)):
            rows_b = self._global_rows[bi]
            for (lo, hi), ds in zip(self._blocks[bi],
                                    self._parts(self._drift_states[bi])):
                if hi <= lo:
                    continue
                flag = ds.fired.cpu().numpy()[:hi - lo]
                if extra:
                    flag = flag | np.isin(rows_b[lo:hi], list(extra))
                if not flag.any():
                    continue
                rho_d = drift_mod.rho_hat(ds, self.replan_config.drift
                                          ).cpu().numpy()
                for j in np.flatnonzero(flag):
                    fired_rows.append(int(rows_b[lo + j]))
                    rhos.append(float(rho_d[j]))
                    bucket_of.append(bi)
                    row_in_bucket.append(int(lo + j))
        if not fired_rows:
            return
        rows = np.asarray(fired_rows, np.int64)
        bounds = []
        for row in rows:
            cm = self._model_of_row.get(row)
            b = self.meter.boundaries[row]
            depth = (cm.t - 1 if hasattr(cm, "t")
                     else int(np.isfinite(b).sum()))
            bounds.append(tuple(b[:depth]))
        exclude = self._excluded_tier_set()
        # the re-solve follows the engine's layout: under its mesh the
        # flagged rows are solved per shard
        with self._span("replan", flagged=len(fired_rows)), \
                fleet.use_fleet_mesh(self.mesh):
            dec = self._replanner.replan(rows, self.meter.observed[rows],
                                         np.asarray(rhos), bounds,
                                         self.meter.migrate[rows],
                                         hwm=self.meter.occupancy_hwm[rows],
                                         exclude_tiers=exclude)
        residual_set, cost_set = set(residual_rows), set(cost_rows)
        touched = set()  # (bucket, shard) pairs whose rows moved
        host_ids = self._resident_ids()
        for j, row in enumerate(rows):
            if not dec.considered[j]:
                continue  # no model / cascade / window over: nothing to log
            moved = 0
            if not dec.feasible[j]:
                self._negotiate_admission(int(row), int(dec.n_seen[j]))
            if dec.applied[j]:
                bi, jb = bucket_of[j], row_in_bucket[j]
                moved = self._apply_row_bounds(int(row), dec.new_bounds[j],
                                               host_ids)
                touched.add((bi, self._locate(bi, jb)[0]))
            self.replan_events.append(ReplanEvent(
                stream_id=self._sid_of_row[int(row)], row=int(row),
                position=int(dec.n_seen[j]), rho=float(dec.rho[j]),
                old_bounds=dec.old_bounds[j], new_bounds=dec.new_bounds[j],
                applied=bool(dec.applied[j]), feasible=bool(dec.feasible[j]),
                suffix_cost_old=float(dec.suffix_cost_old[j]),
                suffix_cost_new=float(dec.suffix_cost_new[j]),
                move_bill=float(dec.move_bill[j]), moved_docs=moved))
            if self._tracer is not None:
                self._tracer.emit(
                    "replan_decision", stream_id=self._sid_of_row[int(row)],
                    row=int(row), position=int(dec.n_seen[j]),
                    rho=float(dec.rho[j]), applied=bool(dec.applied[j]),
                    feasible=bool(dec.feasible[j]), moved_docs=moved,
                    residual_triggered=int(row) in residual_set,
                    cost_triggered=int(row) in cost_set)
        # boundary deltas are placement metadata: the reservoirs themselves
        # must be untouched — every affected shard keeps the sorted-desc
        # score invariant the merge relies on
        for bi, d in touched:
            if self.buckets[bi].engine == "logmem":
                continue  # no reservoir rows to corrupt
            scores = self._parts(self._states[bi])[d].scores.cpu().numpy()
            # note -inf pads diff to NaN on unfull rows — only a strictly
            # positive diff is a genuine order violation
            assert not np.any(np.diff(scores, axis=1) > 0), \
                "re-plan corrupted reservoir score order"
        for bi in set(bucket_of):
            mask = np.zeros(self._pad_m[bi], bool)
            mask[[row_in_bucket[j] for j in range(len(rows))
                  if bucket_of[j] == bi]] = True
            self._reset_drift(bi, mask)
        # the re-plan consumed this evidence: restart the residual and
        # cost channels for the processed rows, like the detector
        mask = np.zeros(self.m, bool)
        mask[rows] = True
        if self._residuals is not None:
            self._residuals.reset_where(mask)
        if self._cost_monitor is not None:
            self._cost_monitor.reset_where(mask)

    def _negotiate_admission(self, row: int, position: int) -> None:
        """A constrained suffix re-solve found no feasible plan (or the
        observed occupancy already violates a capacity): negotiate
        next-window terms for the tenant instead of silently dropping the
        event."""
        from repro_torch.online.admission import AdmissionController
        cm = self._model_of_row.get(row)
        if cm is None:
            return
        cset = self._replanner.csets[row]
        decision = AdmissionController(cset).admit(
            cm.as_ntier() if isinstance(cm, TwoTierCostModel) else cm)
        self.admission_events.append(AdmissionEvent(
            stream_id=self._sid_of_row[row], row=row, position=position,
            decision=decision))
        if self._tracer is not None:
            self._tracer.emit("admission", stream_id=self._sid_of_row[row],
                              row=row, position=position,
                              admitted=bool(getattr(decision, "admitted",
                                                    False)))

    # ---- tier-outage graceful degradation -------------------------------

    def _bucket_of(self, row: int) -> Tuple[int, int]:
        """(bucket index, row within bucket) of a global meter row."""
        for bi, rows in enumerate(self._global_rows):
            if rows.size and rows[0] <= row <= rows[-1]:
                return bi, int(row - rows[0])
        raise KeyError(row)

    def _resident_ids(self):
        """``read(bi, jb)``: a stream's resident ids on the host, one
        device copy per touched shard of a bucket."""
        return self._row_reads(
            lambda bi, d: self._parts(self._states[bi])[d].ids)

    def _apply_row_bounds(self, row: int, new_bounds, host_ids) -> int:
        """Apply a new boundary vector to one stream everywhere it
        lives: host meter (re-tiering residents), the bucket's quantized
        tier_assign bounds (marked stale), device cost ledger, and the
        cost monitor's planned trajectory. ``host_ids`` is a
        ``_resident_ids`` reader. Returns the number of relocated
        residents."""
        bi, jb = self._bucket_of(row)
        ids_arg = None
        if self.buckets[bi].engine != "logmem":
            ids_arg = host_ids(bi, jb)
            self._bounds_stale.add(bi)
        moved = self.meter.apply_boundaries(row, new_bounds, ids_arg)
        if self._cost_states is not None:
            # swap the device ledger's boundary row and the monitor's
            # planned trajectory
            self._set_cost_bounds(bi, jb, self.meter.boundaries[row])
            self._cost_monitor.set_bounds(row, self.meter.boundaries[row])
        return moved

    def _excluded_tier_set(self) -> frozenset:
        """Tiers no plan may place onto right now: failed tiers, plus
        recovered tiers still inside their hysteresis window (expired
        entries are purged — flap damping)."""
        expired = [t for t, until in self._recovering_tiers.items()
                   if self.chunks_ingested >= until]
        for t in expired:
            del self._recovering_tiers[t]
        return frozenset(self._failed_tiers) | frozenset(
            self._recovering_tiers)

    def tier_outage(self, tier: int, *, burn_grace: int = 8) -> Dict:
        """Declare a storage tier failed: mask it out of every future
        re-plan's feasible set and evacuate affected streams onto the
        surviving tiers now — a forced constrained suffix re-solve for
        streams with a cost model (relocation hop-priced, applied on
        feasibility rather than savings), a geometric boundary merge
        (``core.constraints.evacuation_boundaries``) for the rest.

        The relocation spend spike is operator-induced, so the cost
        channel is kept honest rather than silenced wholesale: the
        evacuation bill is credited to each stream's planned trajectory
        (``CostMonitor.add_planned`` — regret does not blame the
        placement) and budget-burn alerts are suppressed for
        ``burn_grace`` chunks on the evacuated rows only.

        Returns a summary dict; emits ``tier_outage`` (and per-stream
        ``tier_evacuation``) on the obs event log. Idempotent: a tier
        already failed returns ``{"already_failed": True}`` without
        re-evacuating (flap protection on the failure side)."""
        nt = self.meter.n_tiers
        if not 0 <= tier < nt:
            raise ValueError(f"tier {tier} out of range (fleet has {nt} "
                             "tiers)")
        if tier in self._failed_tiers:
            return {"tier": tier, "already_failed": True,
                    "rows_evacuated": 0, "rows": [], "moved_docs": 0,
                    "bill": 0.0, "skipped_rows": [],
                    "infeasible_rows": []}
        # a re-failure during recovery hysteresis folds into the outage
        self._recovering_tiers.pop(tier, None)
        self._failed_tiers[tier] = self.chunks_ingested
        self._tier_outages += 1
        summary = self._evacuate_tier(tier, burn_grace=burn_grace)
        if self._tracer is not None:
            self._tracer.emit(
                "tier_outage", tier=tier, chunk=self.chunks_ingested,
                rows_evacuated=summary["rows_evacuated"],
                moved_docs=summary["moved_docs"], bill=summary["bill"],
                skipped=len(summary["skipped_rows"]),
                infeasible=len(summary["infeasible_rows"]))
        return summary

    def tier_recover(self, tier: int, *, hysteresis: int = 2) -> None:
        """Clear a tier's outage. The tier stays masked from re-plans
        for ``hysteresis`` more chunks (flap damping) before placements
        may use it again; evacuated streams migrate back only through
        the ordinary re-plan channel — there is no forced
        un-evacuation."""
        if tier not in self._failed_tiers:
            raise ValueError(f"tier {tier} is not failed")
        del self._failed_tiers[tier]
        self._recovering_tiers[tier] = self.chunks_ingested + int(hysteresis)
        if self._tracer is not None:
            self._tracer.emit(
                "tier_recovered", tier=tier, chunk=self.chunks_ingested,
                masked_until_chunk=int(self._recovering_tiers[tier]))

    def _evacuate_tier(self, tier: int, *, burn_grace: int) -> Dict:
        """Move every affected stream off a failed tier. Affected =
        the tier exists in the stream's placement AND (residents live
        there now, or future arrivals would land there). Cascade
        (migrating) streams cannot re-tier residents and are skipped,
        as are single-tier streams (no surviving tier to move into) —
        both are reported, not silently dropped.

        The device is read once per touched shard of a bucket, not once
        per row: the detector's rho estimate and the resident ids are
        copied to the host on the shard's first evacuated row and
        reused."""
        from repro_torch.core import constraints as cons_mod
        meter = self.meter
        b = meter.boundaries
        m = self.m
        observed = meter.observed.astype(np.float64)
        lo = b[:, tier - 1] if tier > 0 else np.zeros(m)
        hi = (b[:, tier] if tier < b.shape[1] else np.full(m, np.inf))
        exists = np.isfinite(lo) if tier > 0 else np.ones(m, bool)
        resident = ((meter.occupancy[:, tier] > 0)
                    if tier < meter.n_tiers else np.zeros(m, bool))
        future = (hi > lo) & (hi > observed)
        affected = exists & (resident | future)
        rr0 = meter.reloc_reads.copy()
        rw0 = meter.reloc_writes.copy()
        evacuated: List[int] = []
        skipped: List[int] = []
        infeasible: List[int] = []
        touched: set = set()
        moved_total = 0
        exclude = self._excluded_tier_set()
        host_ids = self._resident_ids()
        if self._drift_states is not None:
            from repro_torch.online import drift as drift_mod
            rho_of = self._row_reads(lambda bi, d: drift_mod.rho_hat(
                self._parts(self._drift_states[bi])[d],
                self.replan_config.drift))
        for row in np.flatnonzero(affected):
            row = int(row)
            if meter.migrate[row]:
                skipped.append(row)
                continue
            depth = int(np.isfinite(b[row]).sum())
            if depth == 0:
                skipped.append(row)  # single-tier: nowhere to go
                continue
            old = tuple(float(x) for x in b[row, :depth])
            moved = 0
            applied = False
            if (self._model_of_row.get(row) is not None
                    and self._replanner is not None):
                rho = 1.0
                if self._drift_states is not None:
                    rho = float(rho_of(*self._bucket_of(row)))
                with fleet.use_fleet_mesh(self.mesh):
                    dec = self._replanner.replan(
                        np.asarray([row], np.int64), meter.observed[[row]],
                        np.asarray([rho]), [old], meter.migrate[[row]],
                        hwm=meter.occupancy_hwm[[row]],
                        exclude_tiers=exclude, force=True)
                if not dec.feasible[0]:
                    # the surviving tiers cannot honor the constraints:
                    # negotiate next-window terms, but still evacuate —
                    # data cannot stay on a dead tier
                    infeasible.append(row)
                    self._negotiate_admission(row,
                                              int(meter.observed[row]))
                if dec.applied[0]:
                    moved = self._apply_row_bounds(row, dec.new_bounds[0],
                                                   host_ids)
                    applied = True
            if not applied:
                newb = cons_mod.evacuation_boundaries(old, tier)
                moved = self._apply_row_bounds(row, tuple(newb), host_ids)
            evacuated.append(row)
            touched.add(self._bucket_of(row)[0])
            moved_total += moved
            if self._tracer is not None:
                self._tracer.emit(
                    "tier_evacuation", stream_id=self._sid_of_row[row],
                    row=row, tier=tier, moved_docs=moved,
                    replanned=applied,
                    position=int(meter.observed[row]))
        bill = 0.0
        bills = np.zeros(m, np.float64)
        if self._pricing is not None:
            d_rr = (meter.reloc_reads - rr0).astype(np.float64)
            d_rw = (meter.reloc_writes - rw0).astype(np.float64)
            bills = (d_rr * self._pricing["cr"]).sum(1) \
                + (d_rw * self._pricing["cw"]).sum(1)
            bill = float(bills.sum())
        if evacuated:
            emask = np.zeros(m, bool)
            emask[evacuated] = True
            # the evacuation consumed whatever evidence the monitors had
            # anchored to the old placement — restart it, like a re-plan
            if self._drift_states is not None:
                for bi in sorted(touched):
                    rows_b = self._global_rows[bi]
                    bmask = np.zeros(self._pad_m[bi], bool)
                    bmask[[r - int(rows_b[0]) for r in evacuated
                           if rows_b[0] <= r <= rows_b[-1]]] = True
                    self._reset_drift(bi, bmask)
            if self._residuals is not None:
                self._residuals.reset_where(emask)
            if self._cost_monitor is not None:
                self._cost_monitor.reset_where(emask)
                self._cost_monitor.suppress_burn(emask, burn_grace)
                for row in evacuated:
                    self._cost_monitor.add_planned(row, float(bills[row]))
        return {"tier": tier, "already_failed": False,
                "rows_evacuated": len(evacuated),
                "rows": [int(r) for r in evacuated],
                "moved_docs": int(moved_total), "bill": bill,
                "skipped_rows": skipped, "infeasible_rows": infeasible}

    def drift_scores(self) -> Dict[int, float]:
        """{stream_id: normalized change score} (>= 1 fires; online mode
        only)."""
        from repro_torch.online import drift as drift_mod
        if self._drift_states is None:
            raise ValueError("engine built without replan=")
        out = {}
        for bi, b in enumerate(self.buckets):
            sl = logmem.law_slack(b.k) if b.engine == "logmem" else 0.0
            sc = self._host(bi, self._drift_states[bi],
                            lambda ds, sl=sl: drift_mod.scores(
                                ds, self.replan_config.drift, slack=sl))
            out.update({sid: float(sc[j])
                        for j, sid in enumerate(b.stream_ids)})
        return out

    def states(self) -> List:
        """Per-bucket states: ``BatchedReservoirState`` for exact buckets,
        ``logmem.LogmemState`` for logmem ones. A sharded engine's are
        the shards' rows gathered on shard 0's device, padding cut."""
        if self.mesh is None:
            return list(self._states)
        return [fleet.gather_rows(st, b.m)
                for st, b in zip(self._states, self.buckets)]

    def thresholds(self) -> Dict[int, float]:
        """{stream_id: entry bar} — the K-th score of exact streams, the
        active threshold tau of logmem streams (-inf while unfull)."""
        out = {}
        for bi, b in enumerate(self.buckets):
            bar_fn = (logmem.thresholds if b.engine == "logmem"
                      else thresholds)
            bars = self._host(bi, self._states[bi], bar_fn)
            out.update({sid: float(bars[j])
                        for j, sid in enumerate(b.stream_ids)})
        return out

    def survivors(self) -> Dict[int, np.ndarray]:
        """{stream_id: sorted local doc ids currently in the reservoir}.
        Logmem streams store no ids and report an empty set."""
        out = {}
        for bi, b in enumerate(self.buckets):
            if b.engine == "logmem":
                out.update({sid: np.empty(0, np.int64)
                            for sid in b.stream_ids})
                continue
            ids = self._host(bi, self._states[bi], _ids)
            for j, sid in enumerate(b.stream_ids):
                v = ids[j]
                out[sid] = np.sort(v[v >= 0]).astype(np.int64)
        return out

    def residual_alerts(self) -> Dict[int, int]:
        """{stream_id: docs observed at first alert} of the obs residual
        channel — directly comparable to ``replan_events[i].position``
        (streams that never alerted are absent; obs mode only)."""
        if self._residuals is None:
            raise ValueError("engine built without obs= (or residuals off)")
        out = {}
        for row in np.flatnonzero(self._residuals.first_alert_seen >= 0):
            out[self._sid_of_row[int(row)]] = int(
                self._residuals.first_alert_seen[row])
        return out

    def obs_snapshot(self) -> Dict:
        """Everything the obs layer exports for this engine: drained
        device counters, meter ledger aggregates (per-tier occupancy
        high-water marks, relocations), and the model-referenced
        residual metrics (realized / expected / z for the write law;
        realized / expected for the occupancy law), and the resilience
        block: the ingest cursor, the tier outages and the attached
        checkpointer's counters."""
        from repro_torch.obs import residuals as res_mod
        out: Dict = {"fleet": {"m": self.m, "buckets": len(self.buckets),
                               "logmem_streams":
                                   int(self.meter.logmem.sum())}}
        if self._metrics_state is not None:
            from repro_torch.obs import metrics as metrics_mod
            out["engine"] = metrics_mod.snapshot(self._metrics_view())
        out["meter"] = {
            "observed": int(self.meter.observed.sum()),
            "writes": int(self.meter.writes.sum()),
            "reads": int(self.meter.reads.sum()),
            "deletes": int(self.meter.deletes.sum()),
            "migrations": int(self.meter.migrations.sum()),
            "relocations": int(self.meter.relocations.sum()),
            "occupancy_hwm": [int(x)
                              for x in self.meter.occupancy_hwm.sum(0)],
        }
        # the monitor's totals evaluate the write law at the actual
        # ingest chunking; without it fall back to the per-doc law
        wr = (self._residuals.write_z() if self._residuals is not None
              else res_mod.write_residuals(self.meter))
        occ = res_mod.occupancy_residuals(self.meter)
        out["residuals"] = {
            "writes": {
                "fleet_realized": float(wr["realized"].sum()),
                "fleet_expected": float(wr["expected"].sum()),
                "max_abs_z": float(np.abs(wr["z"]).max()) if self.m else 0.0,
                "mean_z": float(wr["z"].mean()) if self.m else 0.0,
            },
            "occupancy": {
                "fleet_realized": float(np.nansum(occ["realized"])),
                "fleet_expected": float(np.nansum(occ["expected"])),
                # all-NaN before any metered chunk (pure-throughput mode)
                "max_normalized": float(np.nanmax(np.abs(occ["normalized"])))
                if self.m and not np.isnan(occ["normalized"]).all() else 0.0,
            },
        }
        if self._residuals is not None:
            out["residuals"]["alerts"] = self._residuals.snapshot()
        if self._cost_states is not None:
            from repro_torch.obs import costs as costs_mod
            out["costs"] = costs_mod.snapshot(self)
        out["resilience"] = {
            "chunks_ingested": int(self.chunks_ingested),
            "failed_tiers": sorted(self._failed_tiers),
            "recovering_tiers": sorted(self._recovering_tiers),
            "tier_outages": int(self._tier_outages),
        }
        if (self._checkpoint is not None
                and hasattr(self._checkpoint, "snapshot")):
            out["resilience"]["checkpoint"] = self._checkpoint.snapshot()
        return out

    def cost_summary(self) -> Dict:
        """Per-stream realized / planned / regret cost arrays from the
        device ledger + host monitor (``obs.costs.cost_summary``)."""
        if self._cost_states is None:
            raise ValueError("engine built without obs= (or costs off)")
        from repro_torch.obs import costs as costs_mod
        return costs_mod.cost_summary(self)

    def cost_alerts(self) -> Dict[int, Dict]:
        """{stream_id: {"position", "kind"}} of the cost channel's first
        alert per stream — ``kind`` is "residual" or "burn" (whichever
        fired first; streams that never alerted are absent)."""
        if self._cost_monitor is None:
            raise ValueError("engine built without obs= (or costs off)")
        mon = self._cost_monitor
        out: Dict[int, Dict] = {}
        for row in range(self.m):
            res_at = int(mon.first_alert_seen[row])
            burn_at = int(mon.first_burn_seen[row])
            if res_at < 0 and burn_at < 0:
                continue
            if burn_at < 0 or (0 <= res_at <= burn_at):
                out[self._sid_of_row[row]] = {"position": res_at,
                                              "kind": "residual"}
            else:
                out[self._sid_of_row[row]] = {"position": burn_at,
                                              "kind": "burn"}
        return out

    def finalize(self) -> Dict[int, np.ndarray]:
        """End-of-window: meter the final top-K read per stream (tiered by
        each stream's boundaries) and return the survivors. Logmem streams
        meter no reads (no ids on the device) and return empty sets."""
        with self._span("finalize"):
            for bi, b in enumerate(self.buckets):
                if b.engine == "logmem":
                    continue
                self.meter.record_reads(self._global_rows[bi],
                                        self._host(bi, self._states[bi], _ids))
            return self.survivors()

    def assign_tiers(self
                     ) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """Finalize-time tier assignment on the device: one
        ``kernels.tier_assign`` pass per exact bucket maps every survivor
        id against its stream's boundary vector (and cascade floor) to the
        tier its final read must hit, plus the per-tier survivor counts.
        Returns one (tier (M_b, K) int32, counts (M_b, T) int32) pair of
        device tensors per bucket, None for logmem buckets (no ids). A
        sharded engine launches the kernel once a shard and gathers the
        rows on shard 0's device, padding cut."""
        out = []
        for bi, b in enumerate(self.buckets):
            if b.engine == "logmem":
                out.append(None)
                continue
            if bi in self._bounds_stale:
                self._bounds_int[bi] = self._quantized_bounds(bi)
                self._bounds_stale.discard(bi)
            # the cascade floor moves as migrating streams cross their
            # boundaries, so it is read from the meter on every call
            floor = self._to_rows(
                bi, self.meter.floor[self._global_rows[bi]].astype(np.int32))
            pairs = [ta_ops.tier_assign(st.ids, q, f,
                                        n_tiers=self.meter.n_tiers)
                     for st, q, f in zip(self._parts(self._states[bi]),
                                         self._parts(self._bounds_int[bi]),
                                         self._parts(floor))]
            if self.mesh is None:
                out.append(pairs[0])
            else:
                out.append(tuple(fleet.gather_rows(col, b.m)
                                 for col in zip(*pairs)))
        return out

    def finalize_tiers(self) -> Dict[int, Dict]:
        """``assign_tiers`` per stream: {stream_id: {"ids", "tiers",
        "counts"}} as numpy arrays. Agrees with the host meter's tier
        attribution. Logmem streams are absent."""
        out: Dict[int, Dict] = {}
        for bi, pair in enumerate(self.assign_tiers()):
            if pair is None:
                continue
            tier, counts = pair
            tier = tier.cpu().numpy()
            counts = counts.cpu().numpy()
            ids = self._host(bi, self._states[bi], _ids)
            for j, sid in enumerate(self.buckets[bi].stream_ids):
                out[sid] = {"ids": ids[j], "tiers": tier[j],
                            "counts": counts[j]}
        return out

    def check_constraints(self, constraints=None, latencies=None,
                          doc_gb=None) -> Dict:
        """Reconciliation-time violation report against the engine's (or
        an explicit) ``ConstraintSet``: metered occupancy high-water marks
        vs capacities, realized read latency vs the SLO (see
        ``FleetMeter.check_constraints``). Streams planned from cost
        models are checked against the ``effective_capacity`` merge.

        The report's ``"violations"`` key is the structured per-stream
        list ({stream_id, row, tier, kind, measured, limit, margin});
        with ``obs=`` every entry is also emitted on the obs event log as
        a ``constraint_violation`` event."""
        from repro_torch.core.constraints import effective_capacity
        cset = constraints if constraints is not None else self.constraints
        if cset is None:
            raise ValueError("no ConstraintSet given or configured")
        per_stream_caps = None
        if self._model_of_row:
            nt_meter = self.meter.n_tiers
            has_bytes = any(c.max_bytes is not None for c in cset.capacities)
            per_stream_caps = np.empty((self.m, nt_meter))
            sizes = (np.broadcast_to(np.asarray(doc_gb, np.float64),
                                     (self.m,))
                     if doc_gb is not None else None)
            for row in range(self.m):
                cm = self._model_of_row.get(row)
                if cm is not None:
                    nt = (cm.as_ntier()
                          if isinstance(cm, TwoTierCostModel) else cm)
                    cap = np.full(nt_meter, np.inf)
                    cap[:min(nt.t, nt_meter)] = \
                        effective_capacity(cset, nt)[:nt_meter]
                else:
                    if has_bytes and sizes is None:
                        raise ValueError(
                            "byte-denominated capacities need doc_gb for "
                            "streams without a cost model")
                    g = float(sizes[row]) if sizes is not None else 0.0
                    cap = cset.capacity_array(nt_meter, g)
                per_stream_caps[row] = cap
        report = self.meter.check_constraints(cset, latencies=latencies,
                                              doc_gb=doc_gb,
                                              per_stream_caps=per_stream_caps)
        for v in report["violations"]:
            if v["row"] is not None:
                v["stream_id"] = self._sid_of_row[v["row"]]
            if self._tracer is not None:
                self._tracer.emit("constraint_violation", **v)
        return report
