"""repro_torch — the PyTorch / CUDA port of ``repro`` (pySigLib reproduction).

This slice holds the signature-kernel forward path: transforms, the
Goursat solvers, the Gram engine and the MMD / scoring-rule losses, with
three hand-written CUDA kernels for the H100 under
:mod:`repro_torch.kernels.sigkernel_pde`.  Entry points run where their
tensors lie; :class:`SigKernel` runs on the card unless given
``device="cpu"``.  Forward only: gradients come with the next slice.
"""

from .api import SigKernel
from .core import (GridConfig, LaunchConfig, Linear, RBF, TransformPipeline,
                   bucket_length, configs_from_reference, mmd2, pad_ragged,
                   scoring_rule, sigkernel, sigkernel_gram)

__version__ = "0.1.0"

__all__ = [
    "GridConfig", "LaunchConfig", "Linear", "RBF", "SigKernel",
    "TransformPipeline", "bucket_length", "configs_from_reference", "mmd2",
    "pad_ragged", "scoring_rule", "sigkernel", "sigkernel_gram",
]
