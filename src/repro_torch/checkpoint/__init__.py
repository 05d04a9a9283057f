"""Checkpoints in the JAX package's on-disk format (``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruption,
    CheckpointManager,
    available_steps,
    latest_step,
    migrate_host_state,
    quarantine,
    restore,
    save,
)
