"""Ordered N-tier storage topologies — the general setting the paper's
two-tier Algorithm C is a special case of.

Because the per-index write expectation E[writes at i] = min(1, K/(i+1))
(eq. 9/10) is non-increasing in i, the optimal assignment of stream indices
to an *ordered* hierarchy of T tiers is a vector of index thresholds
b_1 <= ... <= b_{T-1}: doc i goes to tier t iff b_t <= i < b_{t+1}
(b_0 = 0, b_T = N). Every adjacent-pair crossover has the same closed form
as eq. 17/21, and eq. 22's validity gate becomes "collapse the tiers whose
boundary leaves their segment empty" — solved exactly in
``shp.plan_placement_ntier`` / ``streams.planner.plan_fleet``.

Conventions (generalizing DESIGN.md §1.1):

* Tier 0 is producer-local (write-cheap, holds early / likely-evicted
  docs); tier T-1 is consumer-local (read-cheap, holds likely survivors).
  Write costs should typically increase and storage rates decrease along
  the hierarchy — the planner does not require it (degenerate orders just
  collapse), but only monotone hierarchies produce interior thresholds.
* ``TierSpec`` bundles a tier's raw billing (``costs.TierCosts``) with its
  producer→tier and tier→consumer transfer rates, so the derived
  per-document costs are cw_t = put_t + xfer_in·doc_GB and
  cr_t = get_t + xfer_out·doc_GB (the two-tier convention, per tier).
* Migration between adjacent tiers follows eq. 19 per boundary:
  cr_t + cw_{t+1} per migrated doc (transfer bundled in cr/cw).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Tuple

if TYPE_CHECKING:  # avoid a runtime cycle: costs.py owns NTierCostModel
    from .costs import NTierCostModel, TierCosts, WorkloadSpec


@dataclass(frozen=True)
class TierSpec:
    """One tier of the hierarchy: raw billing plus its transfer rates on
    the write path (producer → tier) and the read path (tier → consumer).

    ``capacity_docs`` declares a per-tier occupancy bound (documents the
    tier can hold at any instant, None = unbounded) that the constrained
    planner picks up by default (``core.constraints``); ``read_latency_s``
    is the tier's expected per-object retrieval latency, consumed by
    ``ReadLatencySLO`` constraints and by reconciliation-time SLO checks.
    """

    costs: "TierCosts"
    xfer_in_per_gb: float = 0.0
    xfer_out_per_gb: float = 0.0
    capacity_docs: float | None = None
    read_latency_s: float = 0.0

    @property
    def name(self) -> str:
        return self.costs.name


@dataclass(frozen=True)
class TierTopology:
    """An ordered tier hierarchy (tier 0 = producer-local / write side,
    tier T-1 = consumer-local / read side)."""

    tiers: Tuple[TierSpec, ...]
    name: str = ""

    def __post_init__(self):
        if len(self.tiers) < 2:
            raise ValueError(f"a topology needs >= 2 tiers, got {len(self.tiers)}")

    def __len__(self) -> int:
        return len(self.tiers)

    @property
    def t(self) -> int:
        return len(self.tiers)

    @property
    def tier_names(self) -> Tuple[str, ...]:
        return tuple(ts.name for ts in self.tiers)

    def cost_model(self, workload: "WorkloadSpec") -> "NTierCostModel":
        from .costs import NTierCostModel
        return NTierCostModel(topology=self, workload=workload)

    def replace(self, **kw) -> "TierTopology":
        return dataclasses.replace(self, **kw)
