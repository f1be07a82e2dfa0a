"""repro_torch — the PyTorch / CUDA port of ``repro`` (pySigLib reproduction).

This port holds truncated signatures and log-signatures (§2), with the
Horner kernel for the H100 under :mod:`repro_torch.kernels.signature`, and
the signature-kernel path (§3): transforms, the Goursat solvers and their
exact gradient, the Gram engine, its streaming reduction and the MMD /
scoring-rule losses, with the Goursat kernels under
:mod:`repro_torch.kernels.sigkernel_pde`.  Entry points run where their
tensors lie; the modules (:class:`Signature`, :class:`LogSignature`,
:class:`SigKernel`) run on the card unless given ``device="cpu"``.  Every
entry point is differentiable: signatures by the O(1)-memory time-reversed
backward (§2.4), signature kernels by the exact one-pass backward (§3.4),
which on the card runs the checkpoint mode of the forward kernel and the
backward kernel.

:class:`FeatureConfig` switches the Gram entry points and losses to the
RFF / Nyström feature maps.  :class:`Path` (with :class:`RollingConfig`) is
the streaming prefix store: O(1) interval queries and O(chunk) appends;
:mod:`repro_torch.stream` holds it and :mod:`repro_torch.serve` the feature
server built on it.
"""

from .api import LogSignature, SigKernel, Signature
from .core.features import FeatureConfig
from .stream import Path, RollingConfig
from .core import (GridConfig, LaunchConfig, Linear, RBF, StaticKernel, TransformPipeline,
                   bucket_length, configs_from_reference, logsignature,
                   logsignature_combine, logsignature_dim, mmd2, pad_ragged,
                   scoring_rule, sigkernel, sigkernel_gram, sigkernel_gram_reduce,
                   sigkernel_gram_sharded, signature, signature_combine)

__version__ = "0.1.0"

__all__ = [
    "FeatureConfig", "GridConfig", "LaunchConfig", "Linear", "LogSignature", "Path",
    "RBF", "RollingConfig", "SigKernel", "Signature", "StaticKernel", "TransformPipeline",
    "bucket_length",
    "configs_from_reference",
    "logsignature", "logsignature_combine", "logsignature_dim", "mmd2",
    "pad_ragged", "scoring_rule", "sigkernel", "sigkernel_gram",
    "sigkernel_gram_reduce", "sigkernel_gram_sharded", "signature", "signature_combine",
]
