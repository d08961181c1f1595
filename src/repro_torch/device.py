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


def for_script(name) -> torch.device:
    """A script's ``--device`` as a ``torch.device``. A CUDA device
    without a card ends the script (``SystemExit``) before it builds or
    writes anything: there is no fallback to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    return dev
