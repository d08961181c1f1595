"""The tile maximum of the scan kernels' plain versions, with the
reference's bits at zero.

``torch.amax`` returns whichever zero it meets first when a tile's
maximum is zero; the reference's ``jnp.max`` returns +0.0 whenever a
+0.0 is among the reduced entries. The CUDA kernels take the max over
order-preserving ints, which rank -0.0 below +0.0, and give the same
bits as ``tile_max``.
"""
from __future__ import annotations

import torch


def tile_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.amax(dim)``, except that a maximum of zero is +0.0 if any +0.0
    is reduced and -0.0 otherwise. NaN propagates as in ``amax``."""
    m = x.amax(dim)
    pos = ((x == 0) & ~torch.signbit(x)).any(dim)
    return torch.where(m == 0, torch.where(pos, m.abs(), -m.abs()), m)
