"""InternVL2-76B — InternViT (stub frontend) + Llama3-70B-class LM backbone
[arXiv:2404.16821].  Patch embeddings are provided precomputed via
input_specs(); the transformer backbone below is exercised in full."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, act="silu",
    n_patches=256, rope_theta=5e5, moment_dtype="bfloat16",
))
