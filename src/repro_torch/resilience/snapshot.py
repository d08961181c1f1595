"""Whole-engine snapshot/restore: the state surface a crash must not lose —
the port of the reference's ``resilience.snapshot``.

``fleet_snapshot`` captures a ``StreamEngine`` as ``(tree, meta)``:

* the tree holds every fixed-shape array — per-bucket reservoir /
  logmem states and drift evidence sliced to the TRUE row count (shard
  padding stripped, so a checkpoint written at one shard count restores
  onto any other), device cost ledgers, the metrics counters collapsed
  to their mesh-independent canonical form, and the host monitors' state
  dicts (meter ledgers, residual and cost monitor evidence) — plus the
  ingest cursor; its leaves are those of the reference's snapshot, in
  the reference's order (``checkpoint.manager.tree_flatten``);
* ``meta`` is a JSON-able dict carrying everything variable-length or
  structural: the replan/admission event logs, tier-outage bookkeeping,
  and a fleet fingerprint that restore validates against.

Every leaf is a fresh host copy at snapshot time, on the CPU as on the
card (a CPU tensor's ``.numpy()`` would share the engine's memory), so an
async checkpoint write can proceed while the engine mutates on.
``fleet_restore`` is the exact inverse onto a freshly built engine of
any shard count: it re-pads the rows to the target engine's shard
multiple (pad rows take fresh-init values — inert under every law),
places them on the engine's device or its shards' devices, and rebuilds
the host monitors, after which resumed ingestion is bit-identical to the
uninterrupted run. The fingerprint never depends on the mesh.
"""
from __future__ import annotations

from dataclasses import asdict
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import host_copy
from repro_torch.streams import engine as engine_mod


def _host_rows(engine, bi: int, state):
    """Host copies of one bucket's device state (a NamedTuple of
    tensors, one a shard under a fleet mesh), shard padding cut."""
    parts = engine._parts(state)
    m = engine.buckets[bi].m
    leaves = []
    for field in zip(*parts):
        if len(field) == 1:
            leaves.append(host_copy(field[0]))
        else:  # the concatenation is the fresh copy
            leaves.append(np.concatenate(
                [x.detach().cpu().numpy() for x in field])[:m])
    return type(parts[0])(*leaves)


def _fingerprint(engine) -> Dict:
    return {
        "m": int(engine.m),
        "buckets": [{"k": int(b.k), "m": int(b.m), "engine": b.engine,
                     "stream_ids": [int(s) for s in b.stream_ids]}
                    for b in engine.buckets],
        "n_tiers": int(engine.meter.n_tiers),
    }


def fleet_snapshot(engine) -> Tuple[Dict, Dict]:
    """(tree, meta) capturing the engine's full mutable state. The tree's
    structure depends only on the engine's configuration (same specs +
    same obs/replan switches → same leaves), so it doubles as the
    restore template."""
    device: Dict = {"states": [_host_rows(engine, bi, st)
                               for bi, st in enumerate(engine._states)]}
    if engine._drift_states is not None:
        device["drift"] = [_host_rows(engine, bi, ds)
                           for bi, ds in enumerate(engine._drift_states)]
    if engine._metrics_state is not None:
        from repro_torch.obs import metrics as metrics_mod
        counts, score = metrics_mod.to_canonical(engine._metrics_view())
        device["metrics"] = {"counts": counts, "score": score}
    if engine._cost_states is not None:
        device["costs"] = [_host_rows(engine, bi, cs)
                           for bi, cs in enumerate(engine._cost_states)]
    host: Dict = {"meter": engine.meter.state_dict()}
    if engine._residuals is not None:
        host["residuals"] = engine._residuals.state_dict()
    if engine._cost_monitor is not None:
        host["cost_monitor"] = engine._cost_monitor.state_dict()
    tree = {"device": device, "host": host,
            "cursor": np.int64(engine.chunks_ingested)}
    meta = {
        "fleet": _fingerprint(engine),
        "chunks_ingested": int(engine.chunks_ingested),
        "replan_events": [asdict(e) for e in engine.replan_events],
        # the admission decision's plan object is not JSON-able; the
        # negotiated terms are what downstream consumers act on
        "admission_events": [
            {"stream_id": e.stream_id, "row": e.row,
             "position": e.position,
             "decision": {k: v for k, v in asdict(e.decision).items()
                          if k != "plan"}}
            for e in engine.admission_events],
        "failed_tiers": {str(t): c
                         for t, c in engine._failed_tiers.items()},
        "recovering_tiers": {str(t): c
                             for t, c in engine._recovering_tiers.items()},
        "tier_outages": int(engine._tier_outages),
    }
    return tree, meta


def _restore_bucket(engine, bi: int, restored, make):
    """One bucket's restored rows in the engine's layout: re-padded to
    its shard multiple with fresh-init pad rows (``make``, the engine's
    own initializer, at the padded count), in the engine's dtypes, then
    placed on its device or split over its shards."""
    m = engine.buckets[bi].m
    fresh = make(bi, engine._pad_m[bi], torch.device("cpu"))
    if len(restored) != len(fresh):
        raise ValueError(f"checkpoint state has {len(restored)} leaves; "
                         f"the engine's has {len(fresh)}")
    out = []
    for r, f in zip(restored, fresh):
        arr = np.asarray(r)
        want = (m,) + tuple(f.shape[1:])
        if tuple(arr.shape) != want:
            raise ValueError(f"checkpoint leaf of shape {arr.shape} does "
                             f"not match the engine's {want}")
        leaf = f.clone()  # an initializer may share one tensor by leaves
        leaf[:m] = torch.tensor(arr).to(f.dtype)
        out.append(leaf)
    return engine._place(type(fresh)(*out))


def fleet_restore(engine, tree: Dict, meta: Dict) -> None:
    """Load a snapshot into a freshly built engine (same specs and
    obs/replan configuration). Mutates the engine in place; raises
    ``ValueError`` on a fleet-shape mismatch."""
    fp = _fingerprint(engine)
    if meta.get("fleet") not in (None, fp):
        raise ValueError(
            f"checkpoint fleet {meta.get('fleet')} does not match the "
            f"target engine {fp} — restore needs an identically "
            "configured fleet")
    device = tree["device"]
    if len(device["states"]) != len(engine._states):
        raise ValueError(f"checkpoint has {len(device['states'])} buckets; "
                         f"the engine has {len(engine._states)}")
    nb = len(engine.buckets)
    engine._states = [_restore_bucket(engine, bi, device["states"][bi],
                                      engine._make_state)
                      for bi in range(nb)]
    if engine._drift_states is not None:
        if "drift" not in device:
            raise ValueError("checkpoint has no drift state but the "
                             "engine was built with replan=")
        engine._drift_states = [
            _restore_bucket(engine, bi, device["drift"][bi],
                            engine._make_drift) for bi in range(nb)]
    if engine._metrics_state is not None:
        if "metrics" not in device:
            raise ValueError("checkpoint has no metrics state but the "
                             "engine was built with obs metrics on")
        from repro_torch.obs import metrics as metrics_mod
        sharded = engine.mesh is not None
        engine._set_metrics(metrics_mod.from_canonical(
            np.asarray(device["metrics"]["counts"]),
            np.float32(device["metrics"]["score"]),
            device="cpu" if sharded else engine.device,
            shards=engine._shards if sharded else 0))
    if engine._cost_states is not None:
        if "costs" not in device:
            raise ValueError("checkpoint has no cost ledgers but the "
                             "engine was built with obs costs on")
        engine._cost_states = [
            _restore_bucket(engine, bi, device["costs"][bi],
                            engine._make_costs) for bi in range(nb)]
    engine.meter.load_state(tree["host"]["meter"])
    # the meter's boundaries were replaced: every exact bucket's quantized
    # tier_assign bounds must be rebuilt from them before the next
    # finalize_tiers (a checkpoint taken after a re-plan or an outage
    # holds other boundaries than the plan the engine was built with)
    engine._bounds_stale = {bi for bi, b in enumerate(engine.buckets)
                            if b.engine != "logmem"}
    if engine._residuals is not None:
        engine._residuals.load_state(tree["host"]["residuals"])
    if engine._cost_monitor is not None:
        engine._cost_monitor.load_state(tree["host"]["cost_monitor"])
    engine.chunks_ingested = int(tree["cursor"])
    engine.replan_events = [
        engine_mod.ReplanEvent(**{
            **e, "old_bounds": tuple(e["old_bounds"]),
            "new_bounds": tuple(e["new_bounds"])})
        for e in meta.get("replan_events", [])]
    engine.admission_events = []
    if meta.get("admission_events"):
        from repro_torch.online.admission import AdmissionDecision
        for e in meta["admission_events"]:
            engine.admission_events.append(engine_mod.AdmissionEvent(
                stream_id=e["stream_id"], row=e["row"],
                position=e["position"],
                decision=AdmissionDecision(plan=None, **e["decision"])))
    engine._failed_tiers = {int(t): int(c)
                            for t, c in meta.get("failed_tiers",
                                                 {}).items()}
    engine._recovering_tiers = {
        int(t): int(c)
        for t, c in meta.get("recovering_tiers", {}).items()}
    engine._tier_outages = int(meta.get("tier_outages", 0))
