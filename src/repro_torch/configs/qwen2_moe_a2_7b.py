"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed experts, top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, qkv_bias=True, act="silu",
    n_experts=60, n_experts_per_tok=4, n_shared_experts=4, moe_d_ff=1408,
    rope_theta=1e6,
))
