"""Cost model for two-tier top-K placement (paper §IV, Tables I & II).

Conventions locked by reproducing the paper's printed totals (DESIGN.md §1.1):

* Per-document write/read costs bundle the inter-site transfer:
    cw_A = put_A + xfer(producer→A)·doc_GB        (A is producer-local → 0 xfer)
    cw_B = put_B + xfer(producer→B)·doc_GB
    cr_A = get_A + xfer(A→consumer)·doc_GB        (remote pull)
    cr_B = get_B                                   (B is consumer-local)
* Storage ("rental") is per-doc per-window: rate · doc_GB · window_months.
* Migration cost per doc follows eq. 19 literally: cr_A + cw_B.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from .topology import TierTopology

GB_PER_MB = 1.0 / 1000.0  # decimal GB, matching cloud billing
DAYS_PER_MONTH = 30.0


@dataclass(frozen=True)
class TierCosts:
    """Raw billing structure of one storage tier.

    ``min_storage_days`` models lifetime-aware minimum-storage-duration
    charges (S3-IA bills 30 days, Glacier 90): every object written to the
    tier is billed at least that much rental even if deleted or
    transitioned out earlier. ``core.simulator`` tops up each stay to the
    minimum, and ``NTierCostModel.cs`` floors the full-window per-doc
    rental at ``min_storage_days`` for short windows.
    """

    name: str
    put_per_doc: float
    get_per_doc: float
    storage_per_gb_month: float
    min_storage_days: float = 0.0


@dataclass(frozen=True)
class WorkloadSpec:
    """Top-K stream workload parameters (paper §IV)."""

    n_docs: int  # N — stream / window length
    k: int  # K — number of survivors read at window end
    doc_gb: float  # document size in GB
    window_months: float  # stream-window duration in months
    reads_per_window: float = 1.0  # paper's case: one final read

    def __post_init__(self):
        if not (0 < self.k < self.n_docs):
            raise ValueError(f"require 0 < K < N, got K={self.k} N={self.n_docs}")
        if self.doc_gb < 0 or self.window_months < 0:
            raise ValueError("doc_gb / window_months must be non-negative")

    @property
    def n(self) -> int:
        return self.n_docs


@dataclass(frozen=True)
class TwoTierCostModel:
    """Derived per-document costs for Algorithm C ("first r to A, rest to B").

    Tier A is producer-local (write-cheap for early, likely-evicted docs);
    tier B is consumer-local (read-cheap for likely survivors).
    """

    tier_a: TierCosts
    tier_b: TierCosts
    workload: WorkloadSpec
    xfer_producer_to_b_per_gb: float = 0.0
    xfer_a_to_consumer_per_gb: float = 0.0
    xfer_producer_to_a_per_gb: float = 0.0

    # ---- per-document derived costs -------------------------------------
    @property
    def cw_a(self) -> float:
        return self.tier_a.put_per_doc + self.xfer_producer_to_a_per_gb * self.workload.doc_gb

    @property
    def cw_b(self) -> float:
        return self.tier_b.put_per_doc + self.xfer_producer_to_b_per_gb * self.workload.doc_gb

    @property
    def cr_a(self) -> float:
        return self.tier_a.get_per_doc + self.xfer_a_to_consumer_per_gb * self.workload.doc_gb

    @property
    def cr_b(self) -> float:
        return self.tier_b.get_per_doc

    @property
    def cs_a(self) -> float:
        """Per-doc rental in tier A over the full window."""
        return self.tier_a.storage_per_gb_month * self.workload.doc_gb * self.workload.window_months

    @property
    def cs_b(self) -> float:
        return self.tier_b.storage_per_gb_month * self.workload.doc_gb * self.workload.window_months

    @property
    def cs_max(self) -> float:
        """Most-expensive-tier rental — the paper's upper bound for the
        no-migration strategy (rental then constant in r)."""
        return max(self.cs_a, self.cs_b)

    @property
    def migration_per_doc(self) -> float:
        """Eq. 19: read out of A plus write into B."""
        return self.cr_a + self.cw_b

    def replace(self, **kw) -> "TwoTierCostModel":
        return dataclasses.replace(self, **kw)

    def as_ntier(self) -> "NTierCostModel":
        """The exact T=2 view of this model as an ``NTierCostModel``: the
        derived cost vectors are computed with the same arithmetic, so the
        case-study totals reproduce identically through the N-tier path."""
        from .topology import TierSpec, TierTopology
        topo = TierTopology(tiers=(
            TierSpec(self.tier_a,
                     xfer_in_per_gb=self.xfer_producer_to_a_per_gb,
                     xfer_out_per_gb=self.xfer_a_to_consumer_per_gb),
            TierSpec(self.tier_b,
                     xfer_in_per_gb=self.xfer_producer_to_b_per_gb,
                     xfer_out_per_gb=0.0),
        ), name=f"{self.tier_a.name}->{self.tier_b.name}")
        return NTierCostModel(topology=topo, workload=self.workload)


@dataclass(frozen=True)
class NTierCostModel:
    """Derived per-document costs over an ordered ``TierTopology`` —
    the N-tier generalization of ``TwoTierCostModel`` (which is the exact
    T=2 case via :meth:`TwoTierCostModel.as_ntier`).

    All vector properties are ``(T,)`` float64 arrays indexed by tier:
    ``cw``/``cr`` bundle the inter-site transfer exactly like the two-tier
    conventions, ``cs`` is the per-doc full-window rental, and
    ``migration_per_boundary`` is eq. 19 applied per adjacent pair.
    """

    topology: "TierTopology"
    workload: WorkloadSpec

    @property
    def t(self) -> int:
        return self.topology.t

    @property
    def tier_names(self) -> tuple:
        return self.topology.tier_names

    @cached_property
    def cw(self) -> np.ndarray:
        g = self.workload.doc_gb
        return np.array([ts.costs.put_per_doc + ts.xfer_in_per_gb * g
                         for ts in self.topology.tiers], np.float64)

    @cached_property
    def cr(self) -> np.ndarray:
        g = self.workload.doc_gb
        return np.array([ts.costs.get_per_doc + ts.xfer_out_per_gb * g
                         for ts in self.topology.tiers], np.float64)

    @cached_property
    def cs(self) -> np.ndarray:
        """Per-doc rental per tier over the full window, floored at each
        tier's minimum storage duration (a doc resident the whole window
        is still billed at least ``min_storage_days``)."""
        wl = self.workload
        return np.array([ts.costs.storage_per_gb_month * wl.doc_gb
                         * max(wl.window_months,
                               ts.costs.min_storage_days / DAYS_PER_MONTH)
                         for ts in self.topology.tiers], np.float64)

    @cached_property
    def storage_per_doc_month(self) -> np.ndarray:
        """Per-doc-month rental rate per tier (for metered simulation)."""
        return np.array([ts.costs.storage_per_gb_month * self.workload.doc_gb
                         for ts in self.topology.tiers], np.float64)

    @cached_property
    def min_storage_months(self) -> np.ndarray:
        """(T,) minimum billed residency per stay (months); the metered
        simulator tops every stay up to this."""
        return np.array([ts.costs.min_storage_days / DAYS_PER_MONTH
                         for ts in self.topology.tiers], np.float64)

    @cached_property
    def capacity_docs(self) -> np.ndarray:
        """(T,) topology-declared per-tier occupancy bounds (inf where
        undeclared) — picked up by the constrained planner by default."""
        return np.array([np.inf if ts.capacity_docs is None
                         else float(ts.capacity_docs)
                         for ts in self.topology.tiers], np.float64)

    @cached_property
    def read_latency(self) -> np.ndarray:
        """(T,) expected per-object retrieval latency (seconds)."""
        return np.array([ts.read_latency_s for ts in self.topology.tiers],
                        np.float64)

    @property
    def cs_max(self) -> float:
        """Most-expensive-tier rental — the no-migration upper bound."""
        return float(np.max(self.cs))

    @cached_property
    def migration_per_boundary(self) -> np.ndarray:
        """(T-1,) eq. 19 per boundary: read out of tier t, write into t+1."""
        return self.cr[:-1] + self.cw[1:]

    def replace(self, **kw) -> "NTierCostModel":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def case_study_1() -> TwoTierCostModel:
    """Table I: producer at AWS (A = S3), consumer at Azure (B = Blob GPv1).

    The paper lists a single inter-cloud transfer rate (Azure egress
    0.087/GB, S3 ingress 0); calibration shows its totals use that rate for
    both directions of the AWS↔Azure hop.
    """
    wl = WorkloadSpec(n_docs=int(1e8), k=int(1e6), doc_gb=0.1 * GB_PER_MB,
                      window_months=1.0 / DAYS_PER_MONTH)
    s3 = TierCosts("aws-s3", put_per_doc=0.005 / 1000, get_per_doc=0.0004 / 1000,
                   storage_per_gb_month=0.023)
    azure = TierCosts("azure-blob", put_per_doc=0.00036 / 10000,
                      get_per_doc=0.00036 / 10000, storage_per_gb_month=0.024)
    xcloud = 0.087
    return TwoTierCostModel(tier_a=s3, tier_b=azure, workload=wl,
                            xfer_producer_to_b_per_gb=xcloud,
                            xfer_a_to_consumer_per_gb=xcloud)


def case_study_2() -> TwoTierCostModel:
    """Table II: same cloud; A = EFS (free transactions, pricey rental),
    B = S3 (cheap rental, per-transaction fees)."""
    wl = WorkloadSpec(n_docs=int(1e8), k=int(5e6), doc_gb=1.0 * GB_PER_MB,
                      window_months=7.0 / DAYS_PER_MONTH)
    efs = TierCosts("aws-efs", put_per_doc=0.0, get_per_doc=0.0,
                    storage_per_gb_month=0.30)
    s3 = TierCosts("aws-s3", put_per_doc=0.000005, get_per_doc=0.000005,
                   storage_per_gb_month=0.023)
    return TwoTierCostModel(tier_a=efs, tier_b=s3, workload=wl)


def hbm_host_preset(n_docs: int, k: int, doc_gb: float,
                    window_seconds: float,
                    hbm_bw_gbps: float = 819.0,
                    host_link_gbps: float = 32.0,
                    hbm_capacity_premium: float = 50.0) -> TwoTierCostModel:
    """Hardware-derived preset: tier A = device HBM ring buffer (hot),
    tier B = host DRAM over PCIe/DMA (cold).

    "Cost" here is seconds of bandwidth occupancy (write/read = bytes/BW) and
    an HBM capacity-opportunity rental premium. This adapts the paper's cloud
    economics to the TPU memory hierarchy (DESIGN.md §3): the same closed
    forms then place training-reservoir payloads between HBM and host.
    """
    months = window_seconds / (DAYS_PER_MONTH * 24 * 3600)
    hbm = TierCosts("device-hbm", put_per_doc=doc_gb / hbm_bw_gbps,
                    get_per_doc=doc_gb / hbm_bw_gbps,
                    storage_per_gb_month=hbm_capacity_premium)
    host = TierCosts("host-dram", put_per_doc=doc_gb / host_link_gbps,
                     get_per_doc=doc_gb / host_link_gbps,
                     storage_per_gb_month=hbm_capacity_premium / 100.0)
    wl = WorkloadSpec(n_docs=n_docs, k=k, doc_gb=doc_gb, window_months=months)
    return TwoTierCostModel(tier_a=hbm, tier_b=host, workload=wl)
