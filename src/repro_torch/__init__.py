"""repro_torch — the PyTorch / CUDA port of ``repro`` (pySigLib reproduction).

This port holds the signature-kernel path: transforms, the Goursat
solvers and their exact gradient, the Gram engine, its streaming
reduction and the MMD / scoring-rule losses, with the hand-written CUDA
kernels for the H100 under :mod:`repro_torch.kernels.sigkernel_pde`.  Entry points run where their
tensors lie; :class:`SigKernel` runs on the card unless given
``device="cpu"``.  Every entry point is differentiable with the exact
one-pass backward (pySigLib §3.4), which on the card runs the checkpoint
mode of the forward kernel and the backward kernel.
"""

from .api import SigKernel
from .core import (GridConfig, LaunchConfig, Linear, RBF, TransformPipeline,
                   bucket_length, configs_from_reference, mmd2, pad_ragged,
                   scoring_rule, sigkernel, sigkernel_gram, sigkernel_gram_reduce)

__version__ = "0.1.0"

__all__ = [
    "GridConfig", "LaunchConfig", "Linear", "RBF", "SigKernel",
    "TransformPipeline", "bucket_length", "configs_from_reference", "mmd2",
    "pad_ragged", "scoring_rule", "sigkernel", "sigkernel_gram",
    "sigkernel_gram_reduce",
]
