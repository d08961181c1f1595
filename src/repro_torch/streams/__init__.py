# Multi-tenant top-K stream fleet on torch tensors:
#   engine   — BatchedReservoirState + StreamEngine, one step per chunk
#   logmem   — O(log K) threshold-tracker backend for huge-K tenants
#   planner  — vectorized closed-form planning over the fleet (host)
#   router   — mixed-batch → per-(K, backend) bucket scatter (host)
#   metering — per-stream ledgers reconciled against the write law (host)
from . import engine, logmem, metering, planner, router  # noqa: F401
from .engine import BatchedReservoirState, StreamEngine, StreamSpec  # noqa: F401
from .planner import FleetPlan, MixedFleetPlan, plan_fleet, plan_fleet_mixed, waterfill  # noqa: F401
