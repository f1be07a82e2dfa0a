"""Decoder-only layer stacks over full sequences: the dense family.

Counterpart of ``repro/models/transformer.py`` for ``dense`` layers (an
attention block and an MLP, each behind an RMSNorm).  Two parameter
layouts, as in the JAX package: with ``cfg.scan_layers`` the layers'
parameters are stacked under ``{"stacked": ...}`` with a leading layer axis
(the JAX package scans over it; the port loops over its slices), otherwise
each layer is ``layer_{i}``.  ``cfg.remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``, non-reentrant, as ``jax.checkpoint``).
The moe / ssm / hybrid kinds and the prefill / decode paths wait for
ROADMAP item 8b.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import layers as L
from .params import tree_map


def layer_kind(cfg, idx: int) -> str:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family's layers are not ported yet "
            f"(ROADMAP Queue A item 8b); the port builds the 'dense' family")
    return "dense"


def layer_init(generator: torch.Generator, cfg, kind: str):
    dev = generator.device
    return {"ln1": L.rmsnorm_init(cfg.d_model, dev), "ln2": L.rmsnorm_init(cfg.d_model, dev),
            "attn": A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                cfg.qkv_bias),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act)}


def layer_apply(p, x, positions, cfg, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer.  Returns (x, aux_loss); a dense layer's aux is 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + A.attention(p["attn"], h, positions, rope_theta=cfg.rope_theta, causal=True)
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + L.mlp(p["mlp"], h, cfg.act)
    return x, aux


def _uniform(cfg) -> bool:
    return cfg.scan_layers and cfg.family in ("dense", "moe", "vlm", "ssm")


def stack_init(generator: torch.Generator, cfg):
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    layers = [layer_init(generator, cfg, kinds[i]) for i in range(cfg.n_layers)]
    if _uniform(cfg):
        return {"stacked": _stack(layers)}
    return {f"layer_{i}": lp for i, lp in enumerate(layers)}


def _stack(trees):
    """Trees of one structure as one tree with a leading axis on each leaf."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def stack_apply(params, x, positions, cfg):
    """Run all layers over a full sequence.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    if _uniform(cfg):
        layers = [tree_map(lambda a, i=i: a[i], params["stacked"]) for i in range(cfg.n_layers)]
    else:
        layers = [params[f"layer_{i}"] for i in range(cfg.n_layers)]
    for lp, kind in zip(layers, kinds):
        fn = functools.partial(layer_apply, positions=positions, cfg=cfg, kind=kind)
        if cfg.remat:
            x, a = checkpoint(fn, lp, x, use_reentrant=False)
        else:
            x, a = fn(lp, x)
        aux = aux + a
    return x, aux
