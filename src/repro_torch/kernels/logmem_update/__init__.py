from . import ops  # noqa: F401
