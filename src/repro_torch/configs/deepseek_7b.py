"""DeepSeek-7B — llama-arch dense MHA [arXiv:2401.02954]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400, act="silu", rope_theta=1e4,
))
