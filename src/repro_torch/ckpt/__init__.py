from .checkpoint import CheckpointManager  # noqa: F401
