"""Atomic checkpoints and the durable programmed-state store, in the
reference's on-disk format."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointCorruptionError, CheckpointError, CheckpointManager,
    latest_step, load_manifest, restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.program_store import (  # noqa: F401
    CheckpointRejectedError, ProgramStore, StaleCheckpointError)
