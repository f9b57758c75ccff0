"""Checkpointing (port of :mod:`repro.checkpoint`, the same disk layout)."""
from .store import (CheckpointManager, latest_step, restore_pytree,
                    save_pytree)

__all__ = ["save_pytree", "restore_pytree", "latest_step",
           "CheckpointManager"]
