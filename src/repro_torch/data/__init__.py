"""Synthetic data: GBM / fBM paths and a token stream, each batch a pure
function of ``(seed, step)``.  Counterpart of ``repro.data``."""

from .synthetic import PathData, TokenLM, fbm_paths, gbm_paths, step_generator

__all__ = ["PathData", "TokenLM", "fbm_paths", "gbm_paths", "step_generator"]
