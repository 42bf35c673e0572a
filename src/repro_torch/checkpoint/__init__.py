from .checkpointer import Checkpointer, restore_with_resharding

__all__ = ["Checkpointer", "restore_with_resharding"]
