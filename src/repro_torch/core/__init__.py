"""Functional core of the PyTorch port: configs, transforms, dispatch, the
tensor algebra, signatures and log-signatures, the Goursat solvers, the
Gram engine and the losses."""

from .config import (GridConfig, LaunchConfig, Linear, RBF, StaticKernel,
                     TransformPipeline, configs_from_reference, delta_from_gram)
from .dispatch import count_pair_solves
from .gram import sigkernel_gram, sigkernel_gram_reduce
from .logsignature import logsignature, logsignature_combine, logsignature_dim
from .losses import mmd2, scoring_rule
from .sigkernel import (delta_matrix, sigkernel, solve_goursat,
                        solve_goursat_antidiag, solve_goursat_grad)
from .signature import signature, signature_combine, signature_direct
from .transforms import bucket_length, pad_ragged

__all__ = [
    "GridConfig", "LaunchConfig", "Linear", "RBF", "StaticKernel",
    "TransformPipeline", "bucket_length", "configs_from_reference",
    "count_pair_solves", "delta_from_gram", "delta_matrix", "logsignature",
    "logsignature_combine", "logsignature_dim", "mmd2", "pad_ragged",
    "scoring_rule", "sigkernel", "sigkernel_gram", "sigkernel_gram_reduce",
    "signature", "signature_combine", "signature_direct", "solve_goursat",
    "solve_goursat_antidiag", "solve_goursat_grad",
]
