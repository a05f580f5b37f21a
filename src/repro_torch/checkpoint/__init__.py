"""Atomic, retained checkpoints of nested dicts of arrays — the
counterpart of ``repro.checkpoint``, in the same on-disk format."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointManager, all_steps, latest_step, load_checkpoint,
    read_manifest, restore_checkpoint, save_checkpoint,
)

__all__ = ["CheckpointManager", "all_steps", "latest_step",
           "load_checkpoint", "read_manifest", "restore_checkpoint",
           "save_checkpoint"]
