from .checkpoint import (  # noqa: F401
    CheckpointCorruptError, CheckpointManager, latest_step,
    restore_checkpoint, save_checkpoint)
