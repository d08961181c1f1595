# Multi-tenant top-K stream fleet on torch tensors (exact backend):
#   engine   — BatchedReservoirState + StreamEngine, one step per chunk
#   planner  — vectorized closed-form planning over the fleet (host)
#   router   — mixed-batch → per-K bucket scatter (host)
#   metering — per-stream ledgers reconciled against the write law (host)
from . import engine, metering, planner, router  # noqa: F401
from .engine import BatchedReservoirState, StreamEngine, StreamSpec  # noqa: F401
from .planner import FleetPlan, MixedFleetPlan, plan_fleet, plan_fleet_mixed, waterfill  # noqa: F401
