"""Checkpointing through the versioned ObjectStore asset machinery."""

from repro_torch.checkpoint.manager import (CheckpointConfig, CheckpointManager,
                                            load_pytree, save_pytree)

__all__ = ["CheckpointConfig", "CheckpointManager", "load_pytree",
           "save_pytree"]
