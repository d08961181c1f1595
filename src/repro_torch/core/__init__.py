# Host planning math (NumPy copies of the reference's JAX-free modules),
# the torch top-K reservoir (core.topk), the tiered payload store
# (core.tiers) and the interestingness scorers (core.interestingness).
from . import compat, constraints, costs, interestingness, placement, shp, simulator, tiers, topk, topology  # noqa: F401
from .constraints import Constraint, ConstraintSet, ReadLatencySLO, TierCapacity  # noqa: F401
from .costs import NTierCostModel, TierCosts, TwoTierCostModel, WorkloadSpec, case_study_1, case_study_2, hbm_host_preset  # noqa: F401
from .placement import Policy, optimal_policy  # noqa: F401
from .shp import NTierPlacementPlan, PlacementPlan, plan_placement, plan_placement_ntier  # noqa: F401
from .topology import TierSpec, TierTopology  # noqa: F401
