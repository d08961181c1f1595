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

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: online re-planning ``replan=`` (queue 1 item 6),
observability ``obs=`` (item 7) and fleet-axis sharding ``mesh=`` (item
9).
"""
from __future__ import annotations

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


def step(states: Sequence, batches, buckets: Sequence[router.Bucket]):
    """One fleet step over all buckets: ``batches`` holds one (scores,
    ids) (M_b, W) pair per bucket, ``buckets`` the router's buckets (K
    and backend). Returns (new_states, wrotes, evicted) lists, one entry
    per bucket.

    Non-finite scores are quarantined before any compare sees them (NaN
    fails every comparison, ±inf corrupts the entry bar): they become
    inert (-inf, -1) pad slots. Logmem buckets advance through
    ``logmem.update`` and evict nothing ((M_b, 0) evictions). Exact
    buckets with wide batches (W >= K) take ``filtered_update``, narrow
    ones the fused sort-merge ``update``, whose one sort is then
    cheaper."""
    new_states, wrotes, evs = [], [], []
    for st, (s, i), b in zip(states, batches, buckets):
        bad = (i >= 0) & ~torch.isfinite(s)
        s = torch.where(bad, float("-inf"), s)
        i = torch.where(bad, PAD_ID, i)
        if b.engine == "logmem":
            new, wrote = logmem.update(st, s, i, b.k)
            ev = torch.full((s.shape[0], 0), PAD_ID, dtype=torch.int32,
                            device=s.device)
        else:
            if s.shape[1] >= st.scores.shape[1]:
                new, wrote = filtered_update(st, s, i)
            else:
                new, wrote = update(st, s, i)
            ev = evicted_ids(st, new)
        new_states.append(new)
        wrotes.append(wrote)
        evs.append(ev)
    return new_states, wrotes, evs


# ---------------------------------------------------------------------------
# Fleet orchestration
# ---------------------------------------------------------------------------

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


def _readonly_view(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor on ``a``'s memory, used only as a copy source (so a
    read-only array, e.g. a broadcast view, is fine)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable")
        return torch.from_numpy(a)


class _ChunkStager:
    """Double buffer for ``StreamEngine.ingest_chunks`` on the card: two
    slots, each a set of pinned host buffers and device buffers. A chunk
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

    def run(self, slot: int, fn):
        """Run ``fn`` (the step reading the slot) on the compute stream
        once the slot's copy has landed; mark the slot read after it."""
        sl = self.slots[slot]
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(sl["copied"])
        out = fn()
        sl["consumed"].record(compute)
        return out


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
    """

    def __init__(self, specs: Sequence[StreamSpec], *, constraints=None,
                 device=None, replan=None, obs=None, mesh=None):
        for name, value, item in (("replan", replan, 6), ("obs", obs, 7),
                                   ("mesh", mesh, 9)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet (ROADMAP queue 1 item "
                    f"{item})")
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
        self.device = device_mod.resolve(device)
        self.buckets = router.bucket_streams(
            {s.stream_id: s.k for s in specs},
            {s.stream_id: s.engine for s in specs})
        self.router = router.StreamRouter(self.buckets)
        self.constraints = constraints
        # fleet plan for streams that carry a cost model (2- and N-tier mix)
        planned = [s for s in specs if s.explicit_boundaries() is None]
        if planned:
            if any(s.cost_model is None for s in planned):
                raise ValueError(
                    "each stream needs r, boundaries, or a cost_model")
            plan = planner.plan_fleet_mixed(
                [s.cost_model for s in planned], constraints=constraints)
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
        self._states: List = [
            (logmem.init(b.m, device=self.device) if b.engine == "logmem"
             else init(b.m, b.k, device=self.device)) for b in self.buckets]
        # the planned boundaries are fixed for the window (re-planning is
        # not ported): quantize them for tier_assign and move them to the
        # device once; logmem buckets have no survivors to assign
        self._bounds_int = [
            None if b.engine == "logmem" else
            torch.tensor(ta_ops.quantize_boundaries(
                self.meter.boundaries[rows]), device=self.device)
            for b, rows in zip(self.buckets, self._global_rows)]

    @property
    def m(self) -> int:
        return sum(b.m for b in self.buckets)

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
        self._run_chunk(self.router.route(stream_ids, scores, doc_ids,
                                          pad_to=pad_to))

    def _to_device(self, dense) -> list:
        return [(torch.tensor(s, device=self.device),
                 torch.tensor(i, device=self.device)) for s, i in dense]

    def _dispatch(self, batches):
        """Run one fleet step on device batches and swap in the new
        states. The old state tensors return to PyTorch's caching
        allocator, which hands them to the next step: the counterpart of
        the reference's buffer donation."""
        new_states, wrotes, evs = step(self._states, batches, self.buckets)
        self._states = new_states
        return wrotes, evs, new_states

    def _consume(self, dense, wrotes, evs, new_states, meter: bool) -> None:
        """Host side of one step: meter the transactions."""
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
            # their (M_b, 0) eviction set scatters nothing
            st_ids = (None if b.engine == "logmem"
                      else new_states[bi].ids.cpu().numpy())
            self.meter.record_update(
                self._global_rows[bi], dense_ids, wrotes[bi].cpu().numpy(),
                evs[bi].cpu().numpy(), st_ids)

    def _run_chunk(self, dense, *, meter: bool = True) -> None:
        wrotes, evs, new_states = self._dispatch(self._to_device(dense))
        self._consume(dense, wrotes, evs, new_states, meter)

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

        ``meter=False`` skips the per-stream host ledgers for this chunk
        (pure-throughput mode; the device states still advance)."""
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
        stager = _ChunkStager(self.device)
        it = iter(chunks)
        nxt = next(it, None)
        slot = 0
        if nxt is not None:
            nxt = self._checked(nxt)
            staged = stager.stage(slot, nxt)
        count = 0
        while nxt is not None:
            dense, batches = nxt, staged
            wrotes, evs, new_states = stager.run(
                slot, lambda: self._dispatch(batches))
            nxt = next(it, None)
            slot ^= 1
            if nxt is not None:
                nxt = self._checked(nxt)
                staged = stager.stage(slot, nxt)
            # host consumption blocks on chunk t's outputs last
            self._consume(dense, wrotes, evs, new_states, meter)
            count += 1
        return count

    def states(self) -> List:
        """Per-bucket states: ``BatchedReservoirState`` for exact buckets,
        ``logmem.LogmemState`` for logmem ones."""
        return list(self._states)

    def thresholds(self) -> Dict[int, float]:
        """{stream_id: entry bar} — the K-th score of exact streams, the
        active threshold tau of logmem streams (-inf while unfull)."""
        out = {}
        for bi, b in enumerate(self.buckets):
            bar_fn = (logmem.thresholds if b.engine == "logmem"
                      else thresholds)
            bars = bar_fn(self._states[bi]).cpu().numpy()
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
            ids = self._states[bi].ids.cpu().numpy()
            for j, sid in enumerate(b.stream_ids):
                v = ids[j]
                out[sid] = np.sort(v[v >= 0]).astype(np.int64)
        return out

    def finalize(self) -> Dict[int, np.ndarray]:
        """End-of-window: meter the final top-K read per stream (tiered by
        each stream's boundaries) and return the survivors. Logmem streams
        meter no reads (no ids on the device) and return empty sets."""
        for bi, b in enumerate(self.buckets):
            if b.engine == "logmem":
                continue
            self.meter.record_reads(self._global_rows[bi],
                                    self._states[bi].ids.cpu().numpy())
        return self.survivors()

    def assign_tiers(self
                     ) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """Finalize-time tier assignment on the device: one
        ``kernels.tier_assign`` pass per exact bucket maps every survivor
        id against its stream's boundary vector (and cascade floor) to the
        tier its final read must hit, plus the per-tier survivor counts.
        Returns one (tier (M_b, K) int32, counts (M_b, T) int32) pair of
        device tensors per bucket, None for logmem buckets (no ids)."""
        out = []
        for bi, b in enumerate(self.buckets):
            if b.engine == "logmem":
                out.append(None)
                continue
            # the cascade floor moves as migrating streams cross their
            # boundaries, so it is read from the meter on every call
            floor = torch.tensor(
                self.meter.floor[self._global_rows[bi]].astype(np.int32),
                device=self.device)
            out.append(ta_ops.tier_assign(
                self._states[bi].ids, self._bounds_int[bi], floor,
                n_tiers=self.meter.n_tiers))
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
            ids = self._states[bi].ids.cpu().numpy()
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
        models are checked against the ``effective_capacity`` merge."""
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
        return report
