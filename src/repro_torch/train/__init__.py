"""Training steps of the port: mixed precision and microbatch gradient
accumulation around :class:`repro_torch.optim.AdamW`.  Counterpart of
``repro.train``."""

from .step import apply_param_dtype, cast_compute, make_eval_step, make_train_step

__all__ = ["apply_param_dtype", "cast_compute", "make_eval_step", "make_train_step"]
