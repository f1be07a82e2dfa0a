"""Atomic, asynchronous checkpoints of tensor trees, in the JAX package's
layout on disk (:class:`CheckpointManager`).  Counterpart of
``repro.checkpoint``."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
