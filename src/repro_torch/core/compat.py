"""Two-tier scalar-``r`` view of boundary vectors.

The paper's two-tier planner speaks of one changeover index ``r``; the
stack plans boundary vectors. These helpers convert between the two and
normalize a boundary vector. The two-tier constants ``TIER_A``/``TIER_B``
live here too, with one deprecation pathway: a legacy entry point calls
:func:`deprecated`, which emits a single ``DeprecationWarning`` per API
naming the boundary-vector replacement.
"""
from __future__ import annotations

import warnings
from typing import Sequence, Tuple

TIER_A, TIER_B = 0, 1

_WARNED: set = set()


def deprecated(api: str, replacement: str) -> None:
    """Emit one DeprecationWarning per legacy API, pointing at the
    boundary-vector replacement."""
    if api in _WARNED:
        return
    _WARNED.add(api)
    warnings.warn(
        f"{api} is the two-tier scalar-r shim; use {replacement} instead",
        DeprecationWarning, stacklevel=3)


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
