"""Checkpointing substrate."""
from .store import (CheckpointManager, latest_step,  # noqa: F401
                    load_checkpoint, reshard_tree, save_checkpoint)
