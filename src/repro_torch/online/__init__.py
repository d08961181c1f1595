# Drift-aware online re-planning, the port of the reference's
# ``repro.online``: closes the loop from metering back into the paper's
# proactive closed-form planner.
#   drift          — sequential entry-rate statistics vs the analytic K/t
#                    law, (M,)-batched on the engine's device inside its
#                    step (Bernstein-bounded detection, CUSUM, rho-hat)
#   replan         — constrained suffix re-solve over the remaining window
#                    (drift-conditioned laws, hop-priced relocation bill,
#                    hysteresis); host NumPy loop or ``replan_device``
#   replan_device  — the suffix re-solve on torch float64 tensors, the
#                    four-tier subsets through the ``plan_solve`` kernel
#   admission      — negotiate K / window length for tenants whose
#                    constrained plan is infeasible, instead of rejecting
#   evaluate       — realized-cost harness: engine closed loop vs static
#                    plan vs a hindsight drift-aware oracle
from . import admission, drift, evaluate, replan  # noqa: F401
from .admission import AdmissionController, AdmissionDecision  # noqa: F401
from .drift import DriftConfig, DriftEstimator  # noqa: F401
from .replan import Replanner, ReplanConfig, ReplanDecision  # noqa: F401
