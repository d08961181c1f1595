"""Admission control: negotiate K or the window length instead of
rejecting a tenant whose constrained plan is infeasible.

The constrained planner (``shp.plan_placement_ntier``) returns
``total = +inf`` when no boundary vector satisfies the tenant's
``ConstraintSet`` — e.g. a hot-tier capacity below K with an SLO that
forbids the cold tier. The paper's stack so far *rejects* such tenants
(``StreamEngine`` raises). ``AdmissionController`` negotiates instead,
exploiting that the feasible set only grows as K shrinks (the occupancy
law ``min(b,K)(1−b_prev/b)`` is non-decreasing in K and the latency law
is K-free): binary-search the largest feasible K' < K, and only if even
``k_floor`` fails, walk the window length N down a geometric grid
(shorter windows change the write/read balance and can re-open the SLO
frontier). The tenant gets back concrete admitted terms plus the
feasible plan, rather than a refusal. A host copy of the reference's
``online.admission``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import shp
from repro_torch.core.constraints import ConstraintSet
from repro_torch.core.costs import NTierCostModel, TwoTierCostModel


@dataclass(frozen=True)
class AdmissionDecision:
    """Admitted terms for one tenant (possibly negotiated down)."""

    admitted: bool
    negotiated: bool
    k: int
    n_docs: int
    original_k: int
    original_n: int
    plan: Optional[shp.NTierPlacementPlan]
    reason: str

    @property
    def boundaries(self):
        return None if self.plan is None else self.plan.boundaries


def _with_terms(cm: NTierCostModel, k: int, n: int) -> NTierCostModel:
    wl = dataclasses.replace(cm.workload, k=k, n_docs=n)
    return cm.replace(workload=wl)


class AdmissionController:
    """Negotiates admission terms against one ``ConstraintSet``.

    ``k_floor``: smallest reservoir width worth serving; ``n_floor_frac``:
    smallest acceptable window as a fraction of the requested one;
    ``n_steps``: geometric window-shrink grid resolution.
    """

    def __init__(self, constraints: Optional[ConstraintSet] = None, *,
                 k_floor: int = 1, n_floor_frac: float = 0.125,
                 n_steps: int = 6):
        self.constraints = (constraints if constraints is not None
                            else ConstraintSet())
        if k_floor < 1:
            raise ValueError("k_floor must be >= 1")
        self.k_floor = int(k_floor)
        self.n_floor_frac = float(n_floor_frac)
        self.n_steps = int(n_steps)

    def _plan(self, cm: NTierCostModel):
        plan = shp.plan_placement_ntier(cm, constraints=self.constraints)
        return plan if plan.feasible else None

    def _largest_feasible_k(self, cm: NTierCostModel, n: int):
        """Binary-search the largest K' in [k_floor, K] with a feasible
        plan at window n (feasibility is monotone non-increasing in K),
        reusing the plan from the winning probe."""
        k0 = cm.workload.k
        hi = min(k0, n - 1)
        lo = min(self.k_floor, hi)
        best = self._plan(_with_terms(cm, lo, n))
        if best is None:
            return None, None
        while lo < hi:
            mid = (lo + hi + 1) // 2
            probe = self._plan(_with_terms(cm, mid, n))
            if probe is not None:
                lo, best = mid, probe
            else:
                hi = mid - 1
        return lo, best

    def admit(self, cm: NTierCostModel | TwoTierCostModel
              ) -> AdmissionDecision:
        """Admit (possibly renegotiating K, then the window) one tenant."""
        if isinstance(cm, TwoTierCostModel):
            cm = cm.as_ntier()
        wl = cm.workload
        plan = self._plan(cm)
        if plan is not None:
            return AdmissionDecision(True, False, wl.k, wl.n_docs, wl.k,
                                     wl.n_docs, plan, "feasible as requested")
        n_grid = [wl.n_docs]
        n_lo = max(int(wl.n_docs * self.n_floor_frac), self.k_floor + 1)
        step = (n_lo / wl.n_docs) ** (1.0 / max(self.n_steps, 1))
        for i in range(1, self.n_steps + 1):
            n_i = max(int(wl.n_docs * step ** i), n_lo)
            if n_i != n_grid[-1]:
                n_grid.append(n_i)
        for n_i in n_grid:
            k_i, plan = self._largest_feasible_k(cm, n_i)
            if plan is not None:
                what = [f"K {wl.k} -> {k_i}"] if k_i != wl.k else []
                if n_i != wl.n_docs:
                    what.append(f"window {wl.n_docs} -> {n_i}")
                return AdmissionDecision(True, True, k_i, n_i, wl.k,
                                         wl.n_docs, plan,
                                         "negotiated " + ", ".join(what))
        return AdmissionDecision(False, False, wl.k, wl.n_docs, wl.k,
                                 wl.n_docs, None,
                                 f"infeasible even at K={self.k_floor}, "
                                 f"window={n_grid[-1]}")
