"""Atomic, async checkpoints of flat dicts of tensors or numpy arrays."""

from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
