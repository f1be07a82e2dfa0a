"""DBRX-132B — fine-grained 16-expert top-4 MoE [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, act="silu",
    n_experts=16, n_experts_per_tok=4, moe_d_ff=10752,
    rope_theta=5e5, moment_dtype="bfloat16",
))
