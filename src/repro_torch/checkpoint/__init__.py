"""Checkpoint substrate: async, atomic, the JAX package's on-disk layout."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
