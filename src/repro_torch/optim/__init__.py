"""Optimizers of the port: :class:`AdamW` with the JAX package's clipping
and decay, and :func:`cosine_schedule`.  Counterpart of ``repro.optim``; the
int8 gradient compression waits for ROADMAP Queue A item A5."""

from .adamw import AdamW, cosine_schedule

__all__ = ["AdamW", "cosine_schedule"]
