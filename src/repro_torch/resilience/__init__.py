"""Crash consistency and graceful degradation for the fleet engine.

Three pieces, one discipline — every recovery path must reproduce the
uninterrupted run bit-for-bit or say exactly why it cannot:

* ``snapshot`` / ``checkpoint`` — versioned, checksummed, sharding-
  portable snapshot/restore of the full engine state (device reservoirs,
  drift evidence, metric and cost ledgers, host monitors, the ingest
  cursor, and the decision event logs), written at chunk boundaries so
  the npy I/O overlaps the next chunk's compute.
* ``faults`` — deterministic seed-driven fault injection: transient
  chunk-delivery failures with retry/backoff/jitter, duplicate and
  reordered deliveries against the idempotent cursor guard, NaN/Inf
  score lacing, and simulated device loss with restore-from-checkpoint.
* tier outage (``StreamEngine.tier_outage`` / ``outage.TierOutage``) —
  mask a failed tier from the feasible set, evacuate through a forced
  constrained re-solve, and keep the cost channel honest about the bill.
"""
from .checkpoint import FleetCheckpointer
from .faults import (DeviceLossError, FaultyChunkSource,
                     TransientDeliveryError, ingest_with_faults,
                     run_with_recovery)
from .outage import TierOutage
from .snapshot import fleet_restore, fleet_snapshot

__all__ = [
    "FleetCheckpointer", "TierOutage", "fleet_snapshot", "fleet_restore",
    "FaultyChunkSource", "TransientDeliveryError", "DeviceLossError",
    "ingest_with_faults", "run_with_recovery",
]
