"""Optimizers of the port: :class:`AdamW` with the JAX package's clipping
and decay, :func:`cosine_schedule`, and the int8 gradient compression with
error feedback (:func:`psum_compressed` over a ``torch.distributed``
group).  Counterpart of ``repro.optim``."""

from .adamw import AdamW, cosine_schedule
from .compression import (dequantize, init_error_feedback, psum_compressed,
                          psum_compressed_tree, quantize_int8)

__all__ = ["AdamW", "cosine_schedule", "dequantize", "init_error_feedback", "psum_compressed",
           "psum_compressed_tree", "quantize_int8"]
