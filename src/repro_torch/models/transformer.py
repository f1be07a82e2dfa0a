"""Decoder-only layer stacks: the dense and hybrid families, over full
sequences and with decode caches.

Counterpart of ``repro/models/transformer.py`` for the ``dense`` layer (an
attention block and an MLP, each behind an RMSNorm) and the hybrid
family's ``rec`` (RG-LRU block and MLP) and ``attn`` (sliding-window
attention and MLP) layers, RecurrentGemma's (rec, rec, attn) pattern.
Three parameter layouts, as in the JAX package:

* stacked, ``{"stacked": ...}`` with a leading layer axis: ``cfg.scan_layers``
  on a uniform family;
* grouped, ``{"groups": {"pos_j": ...}, "layer_i": ...}``: ``cfg.scan_layers``
  on the hybrid family with at least two pattern groups; ``pos_j`` stacks
  the j-th layer of every group along a leading group axis, and the layers
  after the last whole group stand alone;
* per layer, ``{"layer_i": ...}``, otherwise.

The JAX package scans over the stacked axes; the port loops over views of
their slices.  ``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant, as ``jax.checkpoint``).  Decode
caches take the parameters' layout; :func:`stack_prefill` fills them and
:func:`stack_decode` updates the caches it is given in place (the JAX
package's scan carries donated cache buffers), one layer's slot at a time.
The moe and ssm kinds wait for ROADMAP item 8b.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as A
from . import layers as L
from . import rglru as RG
from .params import tree_map


def layer_kind(cfg, idx: int) -> str:
    if cfg.family == "hybrid":
        return cfg.block_pattern[idx % len(cfg.block_pattern)]
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family's layers are not ported yet "
            f"(ROADMAP Queue A item 8b); the port builds the 'dense' and 'hybrid' families")
    return "dense"


def _window(cfg, kind: str) -> int:
    return cfg.attn_window if (kind == "attn" and cfg.attn_window) else 0


def layer_init(generator: torch.Generator, cfg, kind: str):
    dev = generator.device
    p = {"ln1": L.rmsnorm_init(cfg.d_model, dev), "ln2": L.rmsnorm_init(cfg.d_model, dev)}
    if kind == "rec":
        p["rec"] = RG.rglru_init(generator, cfg)
    else:  # dense or local-attention hybrid layer
        p["attn"] = A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                cfg.qkv_bias)
    p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def layer_apply(p, x, positions, cfg, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer.  Returns (x, aux_loss); these kinds' aux is 0."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        x = x + RG.rglru_apply(p["rec"], h, cfg)
    else:
        x = x + A.attention(p["attn"], h, positions, rope_theta=cfg.rope_theta, causal=True,
                            window=_window(cfg, kind))
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + L.mlp(p["mlp"], h, cfg.act)
    return x, aux


# ---------------------------------------------------------------------------
# decode-path per-layer
# ---------------------------------------------------------------------------

def layer_cache_init(cfg, kind: str, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None):
    """A layer's decode cache: the RG-LRU state (float32), a ring of
    min(window, max_len) slots, or a full KV cache of max_len slots (both
    in ``dtype``)."""
    if kind == "rec":
        return RG.rglru_cache_init(batch, cfg, device=device)
    if _window(cfg, kind):
        return A.window_cache_init(batch, min(cfg.attn_window, max_len), cfg.n_kv_heads,
                                   cfg.hd, dtype, device)
    return A.cache_init(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, device)


def layer_decode(p, x, cache, cur_len: int, cfg, kind: str):
    """One token through one layer; updates ``cache`` in place."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        h, cache = RG.rglru_decode(p["rec"], h, cache, cfg)
    else:
        h, cache = A.decode_attention(p["attn"], h, cache, cur_len, rope_theta=cfg.rope_theta,
                                      window=_window(cfg, kind))
    x = x + h
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, cfg.act), cache


def _layer_prefill(p, h, cache, positions, cfg, kind: str):
    """A layer over the prompt, writing its decode cache into ``cache``."""
    hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    if kind == "rec":
        y, rc = RG.rglru_apply(p["rec"], hn, cfg, return_cache=True)
        h = h + y
        for k, v in rc.items():
            cache[k].copy_(v)
    else:
        window = _window(cfg, kind)
        q, k, v = A.qkv(p["attn"], hn, positions, cfg.rope_theta)
        out = A.blocked_attention(q, k, v, positions, positions, causal=True, window=window)
        h = h + torch.einsum("bshk,hkd->bsd", out, p["attn"]["wo"].to(h.dtype))
        S, slots = hn.shape[1], cache["k"].shape[1]
        if window:   # ring convention: position p lives at slot p % slots
            take = min(slots, S)
            pos = torch.arange(S - take, S, device=h.device)
            cache["k"][:, pos % slots] = k[:, S - take:].to(cache["k"].dtype)
            cache["v"][:, pos % slots] = v[:, S - take:].to(cache["v"].dtype)
            cache["pos"][pos % slots] = pos.to(torch.int32)
        else:
            if S > slots:
                raise ValueError(f"a prompt of {S} tokens does not fit a KV cache of "
                                 f"{slots} slots (max_len)")
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
    hn = L.rmsnorm(p["ln2"], h, cfg.norm_eps)
    return h + L.mlp(p["mlp"], hn, cfg.act)


# ---------------------------------------------------------------------------
# full stacks
# ---------------------------------------------------------------------------

def _uniform(cfg) -> bool:
    return cfg.scan_layers and cfg.family in ("dense", "moe", "vlm", "ssm")


def _grouped(cfg) -> bool:
    return (cfg.scan_layers and cfg.family == "hybrid"
            and cfg.n_layers >= 2 * len(cfg.block_pattern))


def _group_split(cfg):
    g = len(cfg.block_pattern)
    return cfg.n_layers // g, cfg.n_layers % g   # (n_groups, n_rest)


def _stack(trees):
    """Trees of one structure as one tree with a leading axis on each leaf."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}


def _layout(layers: List[Dict], cfg) -> Dict:
    """Per-layer trees (parameters or caches, in layer order) in cfg's
    layout."""
    if _uniform(cfg):
        return {"stacked": _stack(layers)}
    if _grouped(cfg):
        g = len(cfg.block_pattern)
        n_groups, _ = _group_split(cfg)
        tree = {"groups": {f"pos_{j}": _stack([layers[i * g + j] for i in range(n_groups)])
                           for j in range(g)}}
        tree.update({f"layer_{i}": layers[i] for i in range(n_groups * g, cfg.n_layers)})
        return tree
    return {f"layer_{i}": lp for i, lp in enumerate(layers)}


def _layers(tree: Dict, cfg) -> List[Dict]:
    """The inverse of :func:`_layout`: a tree's per-layer subtrees in layer
    order, the stacked ones as views of their slices (an in-place write to
    one lands in the stack)."""
    if _uniform(cfg):
        return [tree_map(lambda a, i=i: a[i], tree["stacked"]) for i in range(cfg.n_layers)]
    if _grouped(cfg):
        g = len(cfg.block_pattern)
        n_groups, _ = _group_split(cfg)
        grouped = [tree_map(lambda a, i=i: a[i], tree["groups"][f"pos_{j}"])
                   for i in range(n_groups) for j in range(g)]
        return grouped + [tree[f"layer_{i}"] for i in range(n_groups * g, cfg.n_layers)]
    return [tree[f"layer_{i}"] for i in range(cfg.n_layers)]


def _kinds(cfg) -> List[str]:
    return [layer_kind(cfg, i) for i in range(cfg.n_layers)]


def stack_init(generator: torch.Generator, cfg):
    """The layers' parameters in cfg's layout, drawn in layer order."""
    kinds = _kinds(cfg)
    return _layout([layer_init(generator, cfg, kind) for kind in kinds], cfg)


def stack_apply(params, x, positions, cfg):
    """Run all layers over a full sequence.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(_layers(params, cfg), _kinds(cfg)):
        fn = functools.partial(layer_apply, positions=positions, cfg=cfg, kind=kind)
        if cfg.remat:
            x, a = checkpoint(fn, lp, x, use_reentrant=False)
        else:
            x, a = fn(lp, x)
        aux = aux + a
    return x, aux


def stack_cache_init(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Zeroed decode caches of every layer, in cfg's layout."""
    return _layout([layer_cache_init(cfg, kind, batch, max_len, dtype, device)
                    for kind in _kinds(cfg)], cfg)


def stack_decode(params, x, caches, cur_len: int, cfg):
    """One token (x: (B, 1, d_model)) through every layer at position
    ``cur_len``; writes each layer's slot of ``caches`` in place (in the
    stored dtypes) and returns (x, caches)."""
    for lp, cache, kind in zip(_layers(params, cfg), _layers(caches, cfg), _kinds(cfg)):
        x, _ = layer_decode(lp, x, cache, cur_len, cfg, kind)
    return x, caches


def stack_prefill(params, x, positions, cfg, max_len: int, dtype=torch.bfloat16):
    """Full-sequence forward that also builds the decode caches (capacity
    ``max_len``; KV caches in ``dtype``).  Returns (x, caches)."""
    caches = stack_cache_init(cfg, x.shape[0], max_len, dtype, x.device)
    for lp, cache, kind in zip(_layers(params, cfg), _layers(caches, cfg), _kinds(cfg)):
        x = _layer_prefill(lp, x, cache, positions, cfg, kind)
    return x, caches
