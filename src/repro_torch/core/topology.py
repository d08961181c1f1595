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


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def aws_s3_tiering(glacier_retrieval_per_gb: float = 0.03,
                   ia_retrieval_per_gb: float = 0.01) -> TierTopology:
    """S3 Standard → Standard-IA → Glacier Instant Retrieval (us-east-1
    list prices): PUT/GET per-request fees rise and storage rental falls
    down the hierarchy, so the migration variant's eq. 21-style crossovers
    are interior while the no-migration reads get *worse* with depth (the
    eq. 22 gate trips and that family falls back to fewer tiers)."""
    from .costs import TierCosts
    std = TierCosts("s3-standard", put_per_doc=0.005 / 1000,
                    get_per_doc=0.0004 / 1000, storage_per_gb_month=0.023)
    ia = TierCosts("s3-standard-ia", put_per_doc=0.01 / 1000,
                   get_per_doc=0.001 / 1000, storage_per_gb_month=0.0125)
    gir = TierCosts("s3-glacier-ir", put_per_doc=0.02 / 1000,
                    get_per_doc=0.01 / 1000, storage_per_gb_month=0.004)
    return TierTopology(tiers=(
        TierSpec(std, read_latency_s=0.02),
        TierSpec(ia, xfer_out_per_gb=ia_retrieval_per_gb,
                 read_latency_s=0.03),
        TierSpec(gir, xfer_out_per_gb=glacier_retrieval_per_gb,
                 read_latency_s=0.08),
    ), name="aws-s3-tiering")


def aws_efs_s3_glacier(glacier_retrieval_per_gb: float = 0.03) -> TierTopology:
    """Case study 2 extended one tier down: EFS (free transactions, pricey
    rental) → S3 Standard → Glacier Instant Retrieval. Because EFS's touch
    cost is zero and the rental drops ~75x across the hierarchy, all three
    tiers genuinely engage under long-window workloads — the flagship
    3-boundary migration cascade (``benchmarks/paper_tables.table_3tier``).
    """
    from .costs import TierCosts
    efs = TierCosts("aws-efs", put_per_doc=0.0, get_per_doc=0.0,
                    storage_per_gb_month=0.30)
    s3 = TierCosts("aws-s3", put_per_doc=0.000005, get_per_doc=0.000005,
                   storage_per_gb_month=0.023)
    gir = TierCosts("s3-glacier-ir", put_per_doc=0.02 / 1000,
                    get_per_doc=0.01 / 1000, storage_per_gb_month=0.004)
    return TierTopology(tiers=(
        TierSpec(efs, read_latency_s=0.003),
        TierSpec(s3, read_latency_s=0.02),
        TierSpec(gir, xfer_out_per_gb=glacier_retrieval_per_gb,
                 read_latency_s=0.08),
    ), name="aws-efs-s3-glacier")


def aws_archive_tiering(flexible_retrieval_per_gb: float = 0.01,
                        flexible_latency_s: float = 4.0 * 3600,
                        min_storage: bool = False) -> TierTopology:
    """S3 Standard → Glacier Flexible Retrieval (us-east-1 list prices):
    the archive tier rents ~6x cheaper than Standard but serves standard
    retrievals in hours, not milliseconds — the hierarchy where a
    read-path SLO (``constraints.ReadLatencySLO``) genuinely bites and
    forces the planner off the cheapest tier. ``min_storage=True`` adds
    Glacier's 90-day minimum-storage-duration billing."""
    from .costs import TierCosts
    std = TierCosts("s3-standard", put_per_doc=0.005 / 1000,
                    get_per_doc=0.0004 / 1000, storage_per_gb_month=0.023)
    gfr = TierCosts("s3-glacier-flexible", put_per_doc=0.03 / 1000,
                    get_per_doc=0.0004 / 1000, storage_per_gb_month=0.0036,
                    min_storage_days=90.0 if min_storage else 0.0)
    return TierTopology(tiers=(
        TierSpec(std, read_latency_s=0.02),
        TierSpec(gfr, xfer_out_per_gb=flexible_retrieval_per_gb,
                 read_latency_s=flexible_latency_s),
    ), name="aws-archive-tiering")


def hbm_dram_disk_preset(n_docs: int, k: int, doc_gb: float,
                         window_seconds: float,
                         hbm_bw_gbps: float = 819.0,
                         host_link_gbps: float = 32.0,
                         disk_bw_gbps: float = 2.0,
                         hbm_capacity_premium: float = 50.0,
                         hbm_capacity_docs: float | None = None
                         ) -> "NTierCostModel":
    """Hardware-derived 3-tier hierarchy: device HBM → host DRAM → local
    disk/object store, extending ``costs.hbm_host_preset`` one level down.
    "Cost" is seconds of bandwidth occupancy plus a capacity-opportunity
    rental premium that falls two orders of magnitude per level.
    ``hbm_capacity_docs`` declares the device slab's hard slot budget
    (HBM is the one tier that physically cannot oversubscribe); the
    constrained planner then keeps the hot boundary under it."""
    from .costs import DAYS_PER_MONTH, NTierCostModel, TierCosts, WorkloadSpec
    months = window_seconds / (DAYS_PER_MONTH * 24 * 3600)
    hbm = TierCosts("device-hbm", put_per_doc=doc_gb / hbm_bw_gbps,
                    get_per_doc=doc_gb / hbm_bw_gbps,
                    storage_per_gb_month=hbm_capacity_premium)
    dram = TierCosts("host-dram", put_per_doc=doc_gb / host_link_gbps,
                     get_per_doc=doc_gb / host_link_gbps,
                     storage_per_gb_month=hbm_capacity_premium / 100.0)
    disk = TierCosts("local-disk", put_per_doc=doc_gb / disk_bw_gbps,
                     get_per_doc=doc_gb / disk_bw_gbps,
                     storage_per_gb_month=hbm_capacity_premium / 10_000.0)
    topo = TierTopology(tiers=(
        TierSpec(hbm, capacity_docs=hbm_capacity_docs,
                 read_latency_s=doc_gb / hbm_bw_gbps),
        TierSpec(dram, read_latency_s=doc_gb / host_link_gbps),
        TierSpec(disk, read_latency_s=doc_gb / disk_bw_gbps),
    ), name="hbm-dram-disk")
    wl = WorkloadSpec(n_docs=n_docs, k=k, doc_gb=doc_gb, window_months=months)
    return NTierCostModel(topology=topo, workload=wl)
