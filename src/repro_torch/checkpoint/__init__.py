"""Atomic checkpoints of the train state (the JAX package's
``repro.checkpoint``), in the reference's on-disk layout."""
from .checkpoint import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
