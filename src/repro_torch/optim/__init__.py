# The optimizer and its learning-rate schedules, the reference's optim:
# AdamW as a pure function of (params, grads, state) and two schedules.
from . import adamw, schedules  # noqa: F401
from .adamw import AdamWState  # noqa: F401
