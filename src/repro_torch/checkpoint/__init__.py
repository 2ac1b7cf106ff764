"""Atomic, async checkpoints with retention (the port of
``repro.checkpoint``)."""
from .store import (CheckpointManager, latest_step, restore_checkpoint,
                    save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
