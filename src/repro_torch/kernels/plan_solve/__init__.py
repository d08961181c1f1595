from . import ops  # noqa: F401
from .ops import enum_solve, monotone_combos, plan_solve  # noqa: F401
