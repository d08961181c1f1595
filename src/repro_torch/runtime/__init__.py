# The training runtime: the train step (loss, gradient through the
# flash_attention kernel pair, AdamW, the NLL-scored top-K reservoir
# merge), prefill/decode steps, and the fault-tolerant training loop.
from . import steps  # noqa: F401
