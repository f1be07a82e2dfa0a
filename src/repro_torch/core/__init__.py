"""Functional core of the PyTorch port: configs, transforms, dispatch, the
tensor algebra, signatures and log-signatures, the Goursat solvers, the
Gram engine, the approximate feature maps and the losses."""

from .config import (GridConfig, LaunchConfig, Linear, RBF, StaticKernel,
                     TransformPipeline, configs_from_reference, delta_from_gram)
from .dispatch import count_combines, count_host_syncs, count_pair_solves, count_scan_steps
from .features import FeatureConfig
from .gram import (StreamingViolation, assert_streaming_reduction, sigkernel_gram,
                   sigkernel_gram_reduce, sigkernel_gram_sharded)
from .logsignature import logsignature, logsignature_combine, logsignature_dim
from .losses import mmd2, scoring_rule, sig_aux_loss
from .sigkernel import (delta_matrix, sigkernel, solve_goursat,
                        solve_goursat_antidiag, solve_goursat_grad)
from .signature import (path_increments, signature, signature_combine, signature_direct,
                        transformed_dim)
from .transforms import (basepoint, bucket_length, lead_lag, pad_ragged, time_augment,
                         transform_increments, transform_path)

__all__ = [
    "FeatureConfig", "GridConfig", "LaunchConfig", "Linear", "RBF", "StaticKernel",
    "StreamingViolation", "TransformPipeline", "assert_streaming_reduction", "basepoint", "bucket_length", "configs_from_reference",
    "count_combines", "count_host_syncs", "count_pair_solves", "count_scan_steps",
    "delta_from_gram", "delta_matrix", "lead_lag", "logsignature", "logsignature_combine",
    "logsignature_dim",
    "mmd2", "pad_ragged", "path_increments", "scoring_rule", "sig_aux_loss", "sigkernel",
    "sigkernel_gram", "sigkernel_gram_reduce", "sigkernel_gram_sharded", "signature",
    "signature_combine", "signature_direct", "solve_goursat", "solve_goursat_antidiag",
    "solve_goursat_grad", "time_augment", "transform_increments", "transform_path",
    "transformed_dim",
]
