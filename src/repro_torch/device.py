"""Where the port's entry points allocate: on the CUDA card unless the
caller names another device. Without a card and without ``device=`` they
raise instead of running on the CPU unasked."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` when given, else the current CUDA device; raises when
    neither is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda")
