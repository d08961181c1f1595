"""Per-stream transaction metering for the fleet engine, reconciled
against the analytic per-stream expectations.

Array-of-ledgers layout: one row per stream, so recording a whole bucket's
update is a handful of vectorized scatter-adds instead of M python ledger
objects. Streams may place across heterogeneous tier depths: each stream
carries a non-decreasing boundary vector (padded with +inf up to the
fleet-wide maximum), and all per-tier arrays are (M, T_max). ``ledger(i)``
materializes a classic ``tiers.Ledger`` view for one stream; ``reconcile``
compares actual write counts to the batched write law
(``shp.expected_cum_writes_batched`` — eq. 11/12 when batch = 1).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core import compat, shp
from repro_torch.core.tiers import Ledger


def __getattr__(name: str):
    # the two-tier constants now live in core.compat — keep the legacy
    # module attributes importable through the single deprecation pathway
    if name in ("TIER_A", "TIER_B"):
        compat.deprecated(f"streams.metering.{name}",
                          f"repro_torch.core.compat.{name}")
        return getattr(compat, name)
    raise AttributeError(name)


def _pad_boundaries(boundaries: Sequence[Sequence[float]]) -> np.ndarray:
    """(M, B_max) float64, each row non-decreasing, padded with +inf so
    shallower streams simply never reach the deeper tiers."""
    bmax = max(len(b) for b in boundaries)
    out = np.full((len(boundaries), bmax), np.inf, np.float64)
    for i, bs in enumerate(boundaries):
        bs = tuple(float(b) for b in bs)
        if any(b2 < b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"stream {i}: boundaries must be non-decreasing")
        out[i, : len(bs)] = bs
    return out


class FleetMeter:
    """Vectorized per-stream ledgers for M streams.

    ``boundaries[i]`` is stream i's changeover vector: a written doc with
    local stream index in [b_t, b_{t+1}) lands in tier t (Algorithm C;
    the classic two-tier case is a single boundary r). Streams flagged in
    ``migrate`` cascade residents of tier t-1 into tier t when the stream
    position crosses b_t (Fig. 3): the meter counts the migrated docs (the
    ``SimResult.migrated`` convention — migration is its own counter, not
    extra reads/writes) and attributes every later delete and every final
    read to the cascade floor.
    """

    def __init__(self, ks: Sequence[int], rs: Sequence[float] | None = None,
                 migrate: Sequence[bool] | None = None, *,
                 boundaries: Sequence[Sequence[float]] | None = None,
                 logmem: Sequence[bool] | None = None):
        m = len(ks)
        self.ks = np.asarray(ks, np.int64)
        if boundaries is None:
            if rs is None:
                raise ValueError("need rs or boundaries")
            boundaries = [compat.boundaries_from_r(r) for r in rs]
        self.boundaries = _pad_boundaries(boundaries)
        assert self.boundaries.shape[0] == m
        self.n_tiers = self.boundaries.shape[1] + 1
        self.migrate = (np.zeros(m, bool) if migrate is None
                        else np.asarray(migrate, bool))
        # O(log K) logmem backend rows: the engine reports no evictions
        # and no final-read ids for them (it stores no ids), so their
        # occupancy equals cumulative writes and the occupancy residual
        # law switches to the per-tier expected-writes form
        # (obs.residuals); logmem + migrate is rejected by the engine
        self.logmem = (np.zeros(m, bool) if logmem is None
                       else np.asarray(logmem, bool))
        self.floor = np.zeros(m, np.int64)  # highest fired boundary per stream
        self.observed = np.zeros(m, np.int64)
        self.writes = np.zeros((m, self.n_tiers), np.int64)
        self.reads = np.zeros((m, self.n_tiers), np.int64)
        self.deletes = np.zeros((m, self.n_tiers), np.int64)
        self.migrations = np.zeros(m, np.int64)
        self.relocations = np.zeros(m, np.int64)  # docs re-tiered by re-plans
        # per-tier hop accounting for cost attribution: a cascade or
        # re-plan move bills one read at the source tier and one write at
        # the destination (the simulator's ``_move_doc`` convention)
        self.mig_reads = np.zeros((m, self.n_tiers), np.int64)
        self.mig_writes = np.zeros((m, self.n_tiers), np.int64)
        self.reloc_reads = np.zeros((m, self.n_tiers), np.int64)
        self.reloc_writes = np.zeros((m, self.n_tiers), np.int64)
        # the storage rental integral: Σ_steps occupancy × docs ingested
        # that step — at chunk width 1 this equals the simulator's
        # per-doc doc-month accounting exactly (priced by obs.costs)
        self.doc_steps = np.zeros((m, self.n_tiers), np.int64)
        # current residents per tier and the running high-water mark,
        # sampled after each recorded step (exact vs the simulator at W=1)
        self.occupancy = np.zeros((m, self.n_tiers), np.int64)
        self.occupancy_hwm = np.zeros((m, self.n_tiers), np.int64)

    @property
    def m(self) -> int:
        return self.ks.shape[0]

    @property
    def rs(self) -> np.ndarray:
        """(M,) first changeover index per stream (the two-tier view)."""
        return self.boundaries[:, 0]

    @property
    def migrated(self) -> np.ndarray:
        """(M,) whether the first cascade has fired."""
        return self.floor > 0

    # ---- recording ------------------------------------------------------

    def _static_tier(self, stream_rows, doc_ids) -> np.ndarray:
        """Arrival-position tier (no cascade floor): # boundaries <= id."""
        b = self.boundaries[stream_rows]  # (Mb, B)
        return (doc_ids[:, :, None] >= b[:, None, :]).sum(axis=-1)

    def _effective_tier(self, stream_rows, doc_ids) -> np.ndarray:
        """Where the doc lives now: static tier, lifted to the cascade
        floor for streams that migrated."""
        return np.maximum(self._static_tier(stream_rows, doc_ids),
                          self.floor[stream_rows][:, None])

    @staticmethod
    def _scatter(counter, stream_rows, tiers, mask) -> None:
        rows2 = np.broadcast_to(stream_rows[:, None], tiers.shape)
        np.add.at(counter, (rows2[mask], tiers[mask]), 1)

    def record_update(self, stream_rows, doc_ids, wrote,
                      evicted_ids=None, state_ids=None) -> None:
        """Account one engine step for a bucket.

        stream_rows (Mb,): global stream indices of the bucket's rows.
        doc_ids (Mb, W) int: per-stream local doc indices, -1 = padding.
        wrote (Mb, W) bool: reservoir-entry mask from the engine.
        evicted_ids (Mb, K) int, optional: local doc indices evicted by this
        step (-1 = none), for per-tier delete accounting.
        state_ids (Mb, K) int, optional: post-step reservoir ids — needed to
        count the docs that cascade when a migrating stream crosses a
        boundary.
        """
        stream_rows = np.asarray(stream_rows, np.int64)
        doc_ids = np.asarray(doc_ids)
        wrote = np.asarray(wrote, bool)
        np.add.at(self.observed, stream_rows, (doc_ids >= 0).sum(1))
        # writes: doc index == arrival position, so the static tier is the
        # write destination with or without a later cascade
        write_tiers = self._static_tier(stream_rows, doc_ids)
        write_mask = wrote & (doc_ids >= 0)
        self._scatter(self.writes, stream_rows, write_tiers, write_mask)
        self._scatter(self.occupancy, stream_rows, write_tiers, write_mask)
        if evicted_ids is not None:
            evicted_ids = np.asarray(evicted_ids)
            # after a cascade nothing lives below the floor anymore
            ev_tiers = self._effective_tier(stream_rows, evicted_ids)
            ev_mask = evicted_ids >= 0
            self._scatter(self.deletes, stream_rows, ev_tiers, ev_mask)
            rows2 = np.broadcast_to(stream_rows[:, None], ev_tiers.shape)
            np.add.at(self.occupancy, (rows2[ev_mask], ev_tiers[ev_mask]), -1)
        if state_ids is not None:
            self._maybe_migrate(stream_rows, np.asarray(state_ids))
        # accrue the rental integral after the step's moves settled
        self.doc_steps[stream_rows] += (
            self.occupancy[stream_rows]
            * (doc_ids >= 0).sum(1).astype(np.int64)[:, None])
        self.occupancy_hwm[stream_rows] = np.maximum(
            self.occupancy_hwm[stream_rows], self.occupancy[stream_rows])

    def _maybe_migrate(self, stream_rows, state_ids) -> None:
        """Fire every boundary whose position the stream just crossed at
        once: residents hop directly to the highest crossed tier (skipping
        zero-width tiers, like the simulator and ``TieredStore`` — with
        W=1 the counts match the simulator exactly)."""
        b = self.boundaries[stream_rows]  # (Mb, B)
        crossed = np.where(np.isfinite(b),
                           self.observed[stream_rows][:, None] >= np.ceil(b),
                           False)
        target = crossed.sum(axis=1)  # highest crossed boundary per stream
        firing = self.migrate[stream_rows] & (target > self.floor[stream_rows])
        if not np.any(firing):
            return
        rows = stream_rows[firing]
        ids = state_ids[firing]
        tiers = np.maximum(
            (ids[:, :, None] >= self.boundaries[rows][:, None, :]).sum(-1),
            self.floor[rows][:, None])
        resident = (ids >= 0) & (tiers < target[firing][:, None])
        np.add.at(self.migrations, rows, resident.sum(1))
        # hop billing: read each resident out of its source tier, write
        # it into the target (``SimResult.mig_reads/mig_writes``)
        rows2 = np.broadcast_to(rows[:, None], tiers.shape)
        np.add.at(self.mig_reads, (rows2[resident], tiers[resident]), 1)
        np.add.at(self.mig_writes, (rows, target[firing]),
                  resident.sum(1))
        # occupancy: every resident below the target hops into it
        occ = self.occupancy[rows]
        tgt = target[firing]
        below = np.arange(self.n_tiers)[None, :] < tgt[:, None]
        moved = np.where(below, occ, 0).sum(1)
        occ = np.where(below, 0, occ)
        occ[np.arange(rows.shape[0]), tgt] += moved
        self.occupancy[rows] = occ
        self.floor[rows] = target[firing]

    def apply_boundaries(self, row: int, new_bounds, state_ids) -> int:
        """Swap one stream's boundary vector mid-window (online re-plan).

        ``state_ids`` are the stream's current resident doc ids (-1 pads).
        Residents whose static tier changes under the new vector are
        re-tiered in place — counted in ``relocations`` and moved between
        the occupancy counters, so capacity reconciliation keeps seeing
        where documents actually live. Later writes, deletes and the
        final read all follow the new boundaries. Migrating (cascade)
        streams cannot be re-planned (the floor semantics would be
        ambiguous). Returns the number of relocated residents.

        Logmem rows (``state_ids=None``) only swap the boundary vector:
        the backend stores no resident ids, so already-written docs stay
        in the tier they were written to (nothing relocatable) and only
        future writes follow the new placement. Returns 0.
        """
        if self.migrate[row]:
            raise ValueError(f"stream row {row} runs a migration cascade — "
                             "online re-planning only supports static "
                             "placements")
        bs = tuple(float(b) for b in new_bounds)
        if any(b2 < b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError("boundaries must be non-decreasing")
        if len(bs) > self.boundaries.shape[1]:
            raise ValueError(f"stream row {row}: {len(bs)} boundaries "
                             f"exceed the fleet-wide maximum depth "
                             f"{self.boundaries.shape[1]}")
        if state_ids is None:
            if not self.logmem[row]:
                raise ValueError(f"stream row {row}: state_ids required "
                                 "for exact-backend re-planning")
            self.boundaries[row, :] = np.inf
            self.boundaries[row, : len(bs)] = bs
            return 0
        ids = np.asarray(state_ids).reshape(-1)
        ids = ids[ids >= 0]
        old_tiers = (ids[:, None] >= self.boundaries[row][None, :]).sum(1)
        self.boundaries[row, :] = np.inf
        self.boundaries[row, : len(bs)] = bs
        new_tiers = (ids[:, None] >= self.boundaries[row][None, :]).sum(1)
        hop = new_tiers != old_tiers
        moved = int(np.sum(hop))
        self.relocations[row] += moved
        np.add.at(self.reloc_reads[row], old_tiers[hop], 1)
        np.add.at(self.reloc_writes[row], new_tiers[hop], 1)
        occ = np.bincount(new_tiers, minlength=self.n_tiers)
        self.occupancy[row] = occ[: self.n_tiers]
        self.occupancy_hwm[row] = np.maximum(self.occupancy_hwm[row],
                                             self.occupancy[row])
        return moved

    # ---- crash-consistent checkpointing ---------------------------------

    _STATE_ARRAYS = (
        "boundaries", "floor", "observed", "writes", "reads", "deletes",
        "migrations", "relocations", "mig_reads", "mig_writes",
        "reloc_reads", "reloc_writes", "doc_steps", "occupancy",
        "occupancy_hwm")

    def state_dict(self) -> Dict[str, np.ndarray]:
        """All mutable ledgers as fresh numpy copies (safe to hand to an
        async checkpoint writer while the engine keeps recording)."""
        return {name: getattr(self, name).copy()
                for name in self._STATE_ARRAYS}

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        for name in self._STATE_ARRAYS:
            ref = getattr(self, name)
            arr = np.asarray(state[name]).astype(ref.dtype).reshape(
                ref.shape)
            setattr(self, name, arr.copy())

    def record_reads(self, stream_rows, doc_ids) -> None:
        """Account the end-of-window top-K read (the consumer side)."""
        stream_rows = np.asarray(stream_rows, np.int64)
        doc_ids = np.asarray(doc_ids)
        if doc_ids.ndim != 2:
            doc_ids = doc_ids.reshape(-1, 1)
        # migrated streams serve the final read from the cascade floor up
        self._scatter(self.reads, stream_rows,
                      self._effective_tier(stream_rows, doc_ids),
                      doc_ids >= 0)

    # ---- reconciliation -------------------------------------------------

    def expected_writes(self, batch: int = 1) -> np.ndarray:
        """(M,) analytic E[total reservoir writes] at each stream's current
        observed length — the batched write law, eq. 11/12 when batch=1.
        Streams that observed nothing expect nothing."""
        out = np.zeros(self.m, np.float64)
        seen = np.maximum(self.observed, 1)
        for k in np.unique(self.ks):
            sel = self.ks == k
            out[sel] = shp.expected_cum_writes_batched(
                seen[sel] - 1, int(k), int(batch))
        return np.where(self.observed > 0, out, 0.0)

    def reconcile(self, batch: int = 1) -> Dict[str, np.ndarray | float]:
        """Actual vs analytic writes per stream. ``mean_rel_err`` is the
        fleet-level sanity number: per-stream counts are single samples of
        the expectation, but averaged over the fleet they concentrate."""
        expected = self.expected_writes(batch=batch)
        actual = self.writes.sum(1).astype(np.float64)
        rel = (actual - expected) / np.maximum(expected, 1e-12)
        return {
            "actual": actual,
            "expected": expected,
            "rel_err": rel,
            "mean_rel_err": float(np.mean(rel)),
            "fleet_actual": float(actual.sum()),
            "fleet_expected": float(expected.sum()),
        }

    def read_latency(self, latencies) -> np.ndarray:
        """(M,) realized mean per-survivor read latency: ``latencies`` is
        (T,) or (M, T) per-tier seconds. Streams with no recorded reads
        report 0."""
        lat = np.broadcast_to(np.asarray(latencies, np.float64),
                              (self.m, self.n_tiers))
        total = (self.reads * lat).sum(1)
        count = self.reads.sum(1)
        return np.where(count > 0, total / np.maximum(count, 1), 0.0)

    def check_constraints(self, constraint_set, latencies=None,
                          doc_gb=None, per_stream_caps=None) -> Dict:
        """Reconciliation-time violation report: compare the *metered*
        occupancy high-water marks (and realized read latency, when
        ``latencies`` is given) against a ``core.constraints``
        ``ConstraintSet``. Shared capacities are checked fleet-wide
        (summed over streams); per-stream capacities per stream.
        Byte-denominated capacities need ``doc_gb`` (scalar or (M,)
        per-stream document sizes) to convert — the meter counts
        documents, not bytes. ``per_stream_caps`` ((M, T)) overrides the
        per-stream capacity computation entirely — the engine passes the
        ``effective_capacity`` merge of topology-declared and explicit
        capacities, which the model-less meter cannot derive itself.
        """
        has_bytes = any(
            c.max_bytes is not None
            for c in (constraint_set.capacities
                      + constraint_set.shared_capacities))
        if has_bytes and doc_gb is None and per_stream_caps is None:
            raise ValueError("byte-denominated capacities need doc_gb to "
                             "convert metered document counts")
        if (doc_gb is None
                and any(c.max_bytes is not None
                        for c in constraint_set.shared_capacities)):
            raise ValueError("shared byte budgets need doc_gb to convert "
                             "metered document counts")
        sizes = (np.broadcast_to(np.asarray(doc_gb, np.float64), (self.m,))
                 if doc_gb is not None else None)
        if per_stream_caps is not None:
            cap = np.asarray(per_stream_caps, np.float64)
        elif sizes is None:
            cap = np.broadcast_to(
                constraint_set.capacity_array(self.n_tiers, 0.0),
                (self.m, self.n_tiers))
        else:
            cap = np.stack([constraint_set.capacity_array(self.n_tiers,
                                                          float(g))
                            for g in sizes])
        capacity_violations = self.occupancy_hwm > cap
        shared_violations: Dict = {}
        for c in constraint_set.shared_capacities:
            if c.tier >= self.n_tiers:
                continue
            occ = self.occupancy_hwm[:, c.tier]
            excess = {}
            if occ.sum() > c.max_docs:
                excess["excess_docs"] = float(occ.sum() - c.max_docs)
            if c.max_bytes is not None:
                used = float((occ * sizes).sum()) * 1e9
                if used > c.max_bytes:
                    excess["excess_bytes"] = used - c.max_bytes
            if excess:
                shared_violations[c.tier] = excess
        slo = constraint_set.max_read_latency
        slo_violations = np.zeros(self.m, bool)
        realized_lat = None
        if latencies is not None and np.isfinite(slo):
            realized_lat = self.read_latency(latencies)
            slo_violations = realized_lat > slo
        # structured per-violation report: one dict per (stream, tier)
        # with the measured value, the limit, and the signed margin
        # (measured − limit > 0 ⇔ violated) — the obs event log's record
        violations = []
        for row, tier in zip(*np.nonzero(capacity_violations)):
            violations.append({
                "row": int(row), "tier": int(tier), "kind": "capacity",
                "measured": float(self.occupancy_hwm[row, tier]),
                "limit": float(cap[row, tier]),
                "margin": float(self.occupancy_hwm[row, tier]
                                - cap[row, tier])})
        for tier, excess in shared_violations.items():
            for key, over in excess.items():
                unit = key.split("_", 1)[1]  # docs | bytes
                violations.append({
                    "row": None, "tier": int(tier),
                    "kind": f"shared_capacity_{unit}",
                    "measured": None, "limit": None,
                    "margin": float(over)})
        for row in np.flatnonzero(slo_violations):
            violations.append({
                "row": int(row), "tier": None, "kind": "slo",
                "measured": float(realized_lat[row]), "limit": float(slo),
                "margin": float(realized_lat[row] - slo)})
        return {
            "capacity_violations": capacity_violations,
            "shared_violations": shared_violations,
            "slo_violations": slo_violations,
            "violations": violations,
            "ok": not violations,
        }

    # ---- classic per-stream view ---------------------------------------

    def ledger(self, i: int) -> Ledger:
        led = Ledger.sized(self.n_tiers)
        led.writes = self.writes[i].copy()
        led.reads = self.reads[i].copy()
        led.deletes = self.deletes[i].copy()
        led.migrations = int(self.migrations[i])
        return led
