"""Committed checkpoints (`checkpoint`): npz + manifest, atomic rename."""
from .checkpoint import (latest_step, restore_checkpoint, save_checkpoint,
                         tree_to_host, wait_for_async)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint",
           "tree_to_host", "wait_for_async"]
