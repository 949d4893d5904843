"""Checkpoint substrate: atomic, checksummed, in the reference's format."""

from .ckpt import (latest_step, list_steps, prune, restore, restore_latest,
                   save, save_async)

__all__ = ["latest_step", "list_steps", "prune", "restore", "restore_latest",
           "save", "save_async"]
