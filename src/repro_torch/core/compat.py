"""Two-tier scalar-``r`` view of boundary vectors.

The paper's two-tier planner speaks of one changeover index ``r``; the
stack plans boundary vectors. These helpers convert between the two and
normalize a boundary vector.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def boundaries_from_r(r: float) -> Tuple[float, ...]:
    """The scalar changeover index as a single-boundary vector."""
    return (float(r),)


def r_from_boundaries(boundaries: Sequence[float]) -> float:
    """The two-tier view of a boundary vector: its first changeover."""
    return float(boundaries[0])


def validate_boundaries(boundaries: Sequence[float],
                        label: str = "boundaries") -> Tuple[float, ...]:
    """Normalize to a non-empty, non-decreasing float tuple."""
    bs = tuple(float(b) for b in boundaries)
    if not bs:
        raise ValueError(f"{label} must be non-empty")
    if any(b2 < b1 for b1, b2 in zip(bs, bs[1:])):
        raise ValueError(f"{label} must be non-decreasing: {bs}")
    return bs
