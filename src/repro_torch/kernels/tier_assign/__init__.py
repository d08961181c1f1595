from . import ops  # noqa: F401
from .ops import quantize_boundaries, tier_assign  # noqa: F401
