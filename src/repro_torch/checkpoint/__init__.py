from repro_torch.checkpoint.checkpointer import (
    Checkpointer, latest_step, restore_tree, save_tree,
)

__all__ = ["Checkpointer", "latest_step", "restore_tree", "save_tree"]
