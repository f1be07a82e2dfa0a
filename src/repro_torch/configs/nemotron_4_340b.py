"""Nemotron-4-340B — dense GQA with squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, act="relu2", rope_theta=1e4,
    # 340B on a 16 GiB/chip pod: bf16 master (TPU stochastic rounding) +
    # bf16 Adam moments — 8 B/param of optimizer state instead of 16
    moment_dtype="bfloat16", param_dtype="bfloat16",
))
