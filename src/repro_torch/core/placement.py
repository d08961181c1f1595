"""Placement policies — Algorithms A/B/C of the paper as executable objects,
generalized to N-tier topologies (``core.topology``).

A policy answers, per stream index, *which tier a reservoir write goes to*,
and whether/when bulk migrations happen. Policies are produced from the
analytic plan (`shp.plan_placement`) — the paper's proactive decision — but
can also be constructed directly for ablations.

The paper's scalar changeover index r is the T=2 special case of a
non-decreasing boundary vector (b_1, ..., b_{T-1}): doc i goes to tier t
iff b_t <= i < b_{t+1}. ``Policy(r=...)`` remains the two-tier constructor.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional, Tuple

from .compat import TIER_A, TIER_B  # noqa: F401  (canonical home: compat)
from .costs import NTierCostModel, TwoTierCostModel
from . import compat, shp


@dataclass(frozen=True)
class Policy:
    """'First b_1 to tier 0, next to tier 1, ...', optional bulk migration
    cascading residents one tier down at each boundary.

    Degenerate cases: b_1 >= N ⇒ all in tier 0; all b = 0 ⇒ everything in
    the last tier (paper eq. 22 fallback for T=2).
    """

    r: Optional[float] = None
    migrate_at_r: bool = False
    name: str = "algoC"
    boundaries: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.boundaries is None:
            if self.r is None:
                raise ValueError("need r or boundaries")
            object.__setattr__(self, "boundaries",
                               compat.boundaries_from_r(self.r))
        else:
            bs = compat.validate_boundaries(self.boundaries)
            object.__setattr__(self, "boundaries", bs)
            if self.r is None:
                object.__setattr__(self, "r", compat.r_from_boundaries(bs))

    @property
    def n_tiers(self) -> int:
        return len(self.boundaries) + 1

    def tier_of(self, index) -> int:
        """Number of boundaries at or below ``index`` (0 = tier A for the
        two-tier case)."""
        return bisect_right(self.boundaries, index)

    def migration_indices(self) -> Tuple[int, ...]:
        """Stream indices at which boundary t's cascade fires (residents of
        tier t-1 move to tier t); empty when the policy never migrates."""
        if not self.migrate_at_r:
            return ()
        return tuple(int(math.ceil(b)) for b in self.boundaries)

    def migration_index(self) -> Optional[int]:
        """First migration trigger (the T=2 shim; see migration_indices)."""
        compat.deprecated("Policy.migration_index",
                          "Policy.migration_indices")
        return int(math.ceil(self.boundaries[0])) if self.migrate_at_r else None


def all_tier_a(n: int) -> Policy:
    return Policy(r=float(n), migrate_at_r=False, name="all_a")


def all_tier_b() -> Policy:
    return Policy(r=0.0, migrate_at_r=False, name="all_b")


def from_plan(plan) -> Policy:
    """Executable policy from a ``shp.PlacementPlan`` (two-tier) or
    ``shp.NTierPlacementPlan`` (multi-threshold)."""
    if isinstance(plan, shp.NTierPlacementPlan):
        if not plan.feasible:
            raise ValueError("no feasible placement under the given "
                             "constraints — relax capacities or the SLO")
        return Policy(boundaries=plan.boundaries, migrate_at_r=plan.migrate,
                      name=plan.strategy)
    s = plan.best.strategy
    if s == "all_tier_a":
        return all_tier_a(plan.n_docs)
    if s == "all_tier_b":
        return all_tier_b()
    if s == "two_tier_no_migration":
        return Policy(r=plan.r_no_migration, migrate_at_r=False, name="algoC_nomig")
    return Policy(r=plan.r_migration, migrate_at_r=True, name="algoC_mig")


def optimal_policy(cm: TwoTierCostModel | NTierCostModel,
                   exact: bool = False, constraints=None) -> Policy:
    """The paper's end-to-end decision: closed-form thresholds, validity
    gate, single-tier fallbacks — all before the stream starts (proactive).
    ``constraints`` (a ``core.constraints.ConstraintSet``) routes through
    the resource-augmented constrained planner."""
    return from_plan(shp.plan_placement(cm, exact=exact,
                                        constraints=constraints))
