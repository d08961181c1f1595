"""Chunk-boundary fleet checkpointing on top of ``checkpoint.manager`` —
the port of the reference's ``resilience.checkpoint``.

``FleetCheckpointer`` wires ``resilience.snapshot`` into the engine's
``attach_checkpointer`` hook: every ``every``-th chunk boundary it
snapshots the engine (host copies only — cheap) and hands the pytree to
the ``CheckpointManager``'s worker thread, so the npy writes overlap the
next chunk's compute (which ``ingest_chunks`` has already staged). Saves
are atomic (temp dir + rename), checksummed, and stamped with the
manager's monotone generation counter, so a kill -9 at ANY point leaves
the latest committed checkpoint intact and lineage totally ordered
across crash/restore cycles.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.checkpoint.manager import CheckpointManager

from . import snapshot as snapshot_mod


class FleetCheckpointer:
    """Crash-consistent checkpointing of one ``StreamEngine``.

    Usage::

        ckpt = FleetCheckpointer(dir, every=8)
        engine.attach_checkpointer(ckpt)     # saves ride chunk boundaries
        engine.ingest_chunks(chunks)
        ...
        # after a crash, on a freshly built identical engine:
        gen = ckpt.restore(engine)           # cursor tells where to resume

    ``every=0`` disables automatic saves (manual ``save`` only).
    ``blocking`` forces synchronous writes (tests; shutdown paths call
    ``save(engine, blocking=True)`` explicitly).
    """

    def __init__(self, directory: str, *, every: int = 1,
                 keep_latest: int = 2, keep_best: int = 0,
                 blocking: bool = False,
                 manager: Optional[CheckpointManager] = None):
        self.manager = manager if manager is not None else \
            CheckpointManager(directory, keep_latest=keep_latest,
                              keep_best=keep_best)
        self.every = int(every)
        self.blocking = bool(blocking)
        self.written = 0

    def on_chunk(self, engine) -> None:
        """The engine's chunk-boundary hook."""
        if self.every and engine.chunks_ingested % self.every == 0:
            self.save(engine, blocking=self.blocking)

    def save(self, engine, blocking: bool = False) -> int:
        """Snapshot now; returns the stamped generation."""
        tree, meta = snapshot_mod.fleet_snapshot(engine)
        gen = self.manager.save(tree, step=int(engine.chunks_ingested),
                                blocking=blocking or self.blocking,
                                extra=meta)
        self.written += 1
        tracer = getattr(engine, "_tracer", None)
        if tracer is not None:
            tracer.emit("checkpoint", step=int(engine.chunks_ingested),
                        generation=int(gen))
        return gen

    def restore(self, engine, step: Optional[int] = None,
                verify: bool = True) -> int:
        """Load a checkpoint (latest by default) into a freshly built
        identical engine; returns the checkpoint's generation. The
        engine's ``chunks_ingested`` cursor afterwards names the next
        chunk to (re)deliver."""
        self.manager.wait()
        template, _ = snapshot_mod.fleet_snapshot(engine)
        tree = self.manager.restore(template, step=step, verify=verify)
        manifest = self.manager.manifest(step)
        snapshot_mod.fleet_restore(engine, tree,
                                   manifest.get("extra", {}))
        return int(manifest.get("generation", 0))

    def wait(self) -> None:
        """Block until any in-flight async save committed."""
        self.manager.wait()

    def snapshot(self) -> Dict:
        """The obs layer's resilience section for this checkpointer."""
        latest = self.manager.latest_step()
        return {"checkpoints_written": int(self.written),
                "generation": int(self.manager.generation()),
                "latest_step": int(latest) if latest is not None else -1,
                "every": int(self.every)}
