"""Mamba2-780m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, ssm_conv=4, ssm_chunk=128,
))
