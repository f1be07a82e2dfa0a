"""Qwen2-72B — dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True, act="silu",
    rope_theta=1e6, moment_dtype="bfloat16",
))
