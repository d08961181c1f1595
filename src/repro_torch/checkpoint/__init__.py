from .manager import CheckpointCorruptError, CheckpointManager  # noqa: F401
