"""Architecture configuration for all supported model families.

A copy of ``repro/models/config.py``.  One dataclass covers the ten
assigned architectures (dense / MoE / VLM / audio enc-dec / SSM / hybrid).
Exact full-size configs live in ``repro_torch.configs.<arch>``; every config
also provides a ``reduced()`` variant for CPU smoke tests.  Of the families,
``dense``, ``moe``, ``ssm``, ``hybrid`` and ``encdec`` build in the port so far
(:func:`repro_torch.models.build_model`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | vlm | encdec | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    act: str = "silu"                       # silu | gelu | relu2
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                       # per-expert hidden size

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    n_audio_frames: int = 1500              # stubbed conv frontend output length

    # --- VLM (internvl) ---
    n_patches: int = 256                    # stubbed ViT patch embeddings

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- hybrid (recurrentgemma) ---
    lru_width: int = 0
    attn_window: int = 0                    # local attention window
    block_pattern: Tuple[str, ...] = ()     # e.g. ("rec", "rec", "attn")

    # --- training ---
    remat: bool = True
    scan_layers: bool = True
    moment_dtype: str = "float32"           # adam moment dtype (bf16 for huge models)
    param_dtype: str = "float32"            # master copy dtype
    compute_dtype: str = "bfloat16"

    # --- paper integration: signature-kernel auxiliary loss (DESIGN.md §4/5) ---
    sig_loss: bool = False
    sig_loss_dim: int = 4
    sig_loss_weight: float = 0.01
    sig_dyadic: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can run long_500k (sub-quadratic sequence mixing)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.block_pattern else
                         max(len(self.block_pattern), 3)),
            d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128, vocab=256, head_dim=16,
            scan_layers=False, remat=False,
            compute_dtype="float32",
        )
        if self.n_experts:
            kw.update(n_experts=4, n_experts_per_tok=2, moe_d_ff=64,
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.n_enc_layers:
            kw.update(n_enc_layers=2, n_audio_frames=16)
        if self.family == "vlm":
            kw.update(n_patches=8)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
        if self.lru_width:
            kw.update(lru_width=64, attn_window=8)
        return self.replace(**kw)


_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    return _REGISTRY[name]


def list_configs():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
