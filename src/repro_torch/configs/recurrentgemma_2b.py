"""RecurrentGemma-2B — RG-LRU recurrent blocks + local attention, pattern
(rec, rec, attn) [arXiv:2402.19427]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, act="gelu", head_dim=256,
    lru_width=2560, attn_window=2048,
    block_pattern=("rec", "rec", "attn"), rope_theta=1e4,
))
