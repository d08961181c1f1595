# Hand-written Hopper kernels, one package each: ops.py holds the wrapper
# (launches the CUDA kernel for a CUDA tensor, runs the plain PyTorch
# version for a CPU tensor), the plain version and the launch counter;
# csrc/ holds the CUDA source, built at first use by kernels.build.
#   batched_topk — fleet bar scan (mask, per-tile count and max)
#   tier_assign  — finalize-time survivor tier assignment + per-tier counts
#   logmem_update — logmem admission scan (mask, per-tile admit/live counts
#                   and live max)
#   topk_filter  — one-stream bar scan behind filter_then_merge
from . import batched_topk, logmem_update, tier_assign, topk_filter  # noqa: F401
