from .manager import (CheckpointManager, latest_step, load_checkpoint,
                      read_meta, save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step", "read_meta"]
