"""PyTorch/CUDA port of the ``repro`` package: the same top-K tiered
placement system, with the TPU kernels rewritten by hand for Hopper.

The layout mirrors ``repro`` so each module's counterpart is easy to
find. The package imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``repro``; kernels are compiled at first use, never on import.
Entry points run on the CUDA card unless given ``device="cpu"``.
"""
from . import configs, core, data, kernels, models, streams  # noqa: F401
