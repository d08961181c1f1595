# Fleet observability for the port. Only the timing API is ported so far
# (``online.evaluate`` needs ``timers.span``); the rest of the reference's
# ``repro.obs`` is ROADMAP queue 1 item 7.
#   timers — span / time_best
from . import timers  # noqa: F401
