"""Decoder-only layer stacks: the dense, MoE, vlm, SSM and hybrid families,
over full sequences and with decode caches.

Counterpart of ``repro/models/transformer.py`` for the ``dense`` layer (an
attention block and an MLP, each behind an RMSNorm; the vlm family's
layers too), the ``moe`` layer (attention and a Mixture-of-Experts block,
:mod:`.moe`, whose auxiliary loss the stack sums), the ``ssm`` layer (a
Mamba-2 block, :mod:`.ssm`, behind one RMSNorm, with no MLP) and the hybrid
family's ``rec`` (RG-LRU block and MLP) and ``attn`` (sliding-window
attention and MLP) layers, RecurrentGemma's (rec, rec, attn) pattern.  Three parameter layouts, as
in the JAX package:

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
A stacked tree is allocated once and each layer is written into its slice
as it is drawn, so a build holds the parameters once (and one layer's
draw).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.api import gather_fsdp, local_call, on_mesh, shard, shard_index, write_local
from . import attention as A
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import ssm as SSM
from .params import tree_items, tree_map

def layer_kind(cfg, idx: int) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        return cfg.block_pattern[idx % len(cfg.block_pattern)]
    if cfg.family == "moe":
        return "moe"
    return "dense"       # dense and vlm


def _window(cfg, kind: str) -> int:
    return cfg.attn_window if (kind == "attn" and cfg.attn_window) else 0


def layer_init(generator: torch.Generator, cfg, kind: str):
    dev = generator.device
    if kind == "ssm":
        return {"ln": L.rmsnorm_init(cfg.d_model, dev), "mixer": SSM.ssm_init(generator, cfg)}
    p = {"ln1": L.rmsnorm_init(cfg.d_model, dev), "ln2": L.rmsnorm_init(cfg.d_model, dev)}
    if kind == "rec":
        p["rec"] = RG.rglru_init(generator, cfg)
    else:  # dense, moe or local-attention hybrid layer
        p["attn"] = A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                cfg.qkv_bias)
    if kind == "moe":
        p["moe"] = MOE.moe_init(generator, cfg)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def _ffn(p, h, cfg, kind: str):
    """The layer's second block on the normed input: (out, aux)."""
    if kind == "moe":
        return MOE.moe_apply(p["moe"], h, cfg)
    return L.mlp(p["mlp"], h, cfg.act), None


def layer_apply(p, x, positions, cfg, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer.  Returns (x, aux_loss); aux is the MoE block's,
    0 for the other kinds.  On a mesh the sequence-parallel residual is
    gathered at the layer's entry."""
    x = shard(x, "batch", "seq", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        return x + SSM.ssm_apply(p["mixer"], L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg), aux
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        x = x + RG.rglru_apply(p["rec"], h, cfg)
    else:
        x = x + A.attention(p["attn"], h, positions, rope_theta=cfg.rope_theta, causal=True,
                            window=_window(cfg, kind))
    y, a = _ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, kind)
    return x + y, aux if a is None else a


# ---------------------------------------------------------------------------
# decode-path per-layer
# ---------------------------------------------------------------------------

def layer_cache_init(cfg, kind: str, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None):
    """A layer's decode cache: the SSM conv window and state or the RG-LRU
    state (float32, whatever ``dtype``), a ring of min(window, max_len)
    slots, or a full KV cache of max_len slots (both in ``dtype``)."""
    if kind == "ssm":
        return SSM.ssm_cache_init(batch, cfg, device=device)
    if kind == "rec":
        return RG.rglru_cache_init(batch, cfg, device=device)
    if _window(cfg, kind):
        return A.window_cache_init(batch, min(cfg.attn_window, max_len), cfg.n_kv_heads,
                                   cfg.hd, dtype, device)
    return A.cache_init(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, device)


def layer_decode(p, x, cache, cur_len: int, cfg, kind: str):
    """One token through one layer; updates ``cache`` in place."""
    if kind == "ssm":
        h, cache = SSM.ssm_decode(p["mixer"], L.rmsnorm(p["ln"], x, cfg.norm_eps), cache, cfg)
        return x + h, cache
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        h, cache = RG.rglru_decode(p["rec"], h, cache, cfg)
    else:
        h, cache = A.decode_attention(p["attn"], h, cache, cur_len, rope_theta=cfg.rope_theta,
                                      window=_window(cfg, kind))
    x = x + h
    y, _ = _ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, kind)
    return x + y, cache


def _layer_prefill(p, h, cache, positions, cfg, kind: str):
    """A layer over the prompt, writing its decode cache into ``cache``."""
    if kind == "ssm":   # O(1) in the prompt's length: no max_len to check
        y, sc = SSM.ssm_apply(p["mixer"], L.rmsnorm(p["ln"], h, cfg.norm_eps), cfg,
                              return_cache=True)
        for k, v in sc.items():
            if on_mesh(v):
                write_local(cache[k], v)
            else:
                cache[k].copy_(v)
        return h + y
    hn = L.rmsnorm(p["ln1"], h, cfg.norm_eps)
    if kind == "rec":
        y, rc = RG.rglru_apply(p["rec"], hn, cfg, return_cache=True)
        h = h + y
        for k, v in rc.items():
            if on_mesh(v):
                write_local(cache[k], v)
            else:
                cache[k].copy_(v)
    else:
        window = _window(cfg, kind)
        q, k, v = A.qkv(p["attn"], hn, positions, cfg.rope_theta)
        out = A.blocked_attention(q, k, v, positions, positions, causal=True, window=window)
        h = h + shard(torch.einsum("bshk,hkd->bsd", out, p["attn"]["wo"].to(h.dtype)),
                      "batch", "seq", None)
        S, slots = hn.shape[1], cache["k"].shape[1]
        if window and on_mesh(k):
            _ring_write_on_mesh(cache, k, v, S)
        elif window:   # ring convention: position p lives at slot p % slots
            take = min(slots, S)
            pos = torch.arange(S - take, S, device=h.device)
            cache["k"][:, pos % slots] = k[:, S - take:].to(cache["k"].dtype)
            cache["v"][:, pos % slots] = v[:, S - take:].to(cache["v"].dtype)
            cache["pos"][pos % slots] = pos.to(torch.int32)
        else:
            if S > slots:
                raise ValueError(f"a prompt of {S} tokens does not fit a KV cache of "
                                 f"{slots} slots (max_len)")
            if on_mesh(k):
                write_local(cache["k"], k, 1)
                write_local(cache["v"], v, 1)
            else:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
    y, _ = _ffn(p, L.rmsnorm(p["ln2"], h, cfg.norm_eps), cfg, kind)
    return h + y


def _ring_write_on_mesh(cache, k, v, S: int) -> None:
    """The ring-cache write of :func:`_layer_prefill` on a mesh: each
    device writes the slots of its cache shard (a slice of the slots where
    the KV heads do not divide the model axis), every device the whole
    ``pos`` ring."""
    from torch.distributed.tensor import Replicate
    ck = cache["k"]
    mesh, slots = ck.device_mesh, ck.shape[1]
    axes = [i for i, p in enumerate(ck.placements) if p.is_shard(1)]
    full = tuple(Replicate() if p.is_shard(1) else p for p in ck.placements)
    k = k.to(ck.dtype).redistribute(mesh, full)
    v = v.to(ck.dtype).redistribute(mesh, full)
    n = slots // math.prod(mesh.size(a) for a in axes)
    lo = shard_index(mesh, axes) * n
    take = min(slots, S)
    # the position each local slot holds: the last of the prompt's final
    # ``take`` positions congruent to it
    pairs = [(s - lo, p) for s in range(lo, lo + n)
             for p in [S - 1 - ((S - 1 - s) % slots)] if p >= S - take]

    def write(ckl, cvl, posl, kl, vl):
        dst = torch.tensor([d for d, _ in pairs], device=kl.device)
        src = torch.tensor([p for _, p in pairs], device=kl.device)
        ckl[:, dst] = kl[:, src]
        cvl[:, dst] = vl[:, src]
        pos = torch.arange(S - take, S, device=kl.device)
        posl[pos % slots] = pos.to(torch.int32)
        return posl

    local_call(write, (ck, cache["v"], cache["pos"], k, v), (...,) * 5,
               ([*cache["pos"].placements],), (cache["pos"].shape,))


# ---------------------------------------------------------------------------
# full stacks
# ---------------------------------------------------------------------------

def _uniform(cfg) -> bool:
    return cfg.scan_layers and cfg.family in ("dense", "moe", "vlm", "ssm", "encdec")


def _grouped(cfg) -> bool:
    return (cfg.scan_layers and cfg.family == "hybrid"
            and cfg.n_layers >= 2 * len(cfg.block_pattern))


def _group_split(cfg):
    g = len(cfg.block_pattern)
    return cfg.n_layers // g, cfg.n_layers % g   # (n_groups, n_rest)


def _slot(cfg, i: int):
    """Where layer ``i`` lives in cfg's layout: (path of keys, index along
    the stacked axis or None, that axis' length)."""
    if _uniform(cfg):
        return ("stacked",), i, cfg.n_layers
    if _grouped(cfg):
        g = len(cfg.block_pattern)
        n_groups, _ = _group_split(cfg)
        if i < n_groups * g:
            return ("groups", f"pos_{i % g}"), i // g, n_groups
    return (f"layer_{i}",), None, 1


def _build(make, cfg) -> Dict:
    """The per-layer trees ``make(i)``, made in layer order, in cfg's
    layout.  A stacked leaf is allocated when its first layer is made and
    each layer is copied into its slice before the next is made, so the
    build holds the stacked trees once beside one layer's tree."""
    tree: Dict = {}
    for i in range(cfg.n_layers):
        keys, idx, n = _slot(cfg, i)
        lp = make(i)
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if idx is None:
            node[keys[-1]] = lp
            continue
        if keys[-1] not in node:
            node[keys[-1]] = tree_map(lambda a: a.new_empty((n,) + a.shape), lp)
        for (_, dst), (_, src) in zip(tree_items(node[keys[-1]]), tree_items(lp)):
            dst[idx].copy_(src)
        del lp
    return tree


def _layers(tree: Dict, cfg) -> List[Dict]:
    """The inverse of :func:`_build`: a tree's per-layer subtrees in layer
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
    return _build(lambda i: layer_init(generator, cfg, kinds[i]), cfg)


def stack_apply(params, x, positions, cfg):
    """Run all layers over a full sequence.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(_layers(params, cfg), _kinds(cfg)):
        lp = gather_fsdp(lp)
        x = shard(x, "batch", "residual", None)   # SP residual boundary
        fn = functools.partial(layer_apply, positions=positions, cfg=cfg, kind=kind)
        if cfg.remat:
            x, a = checkpoint(fn, lp, x, use_reentrant=False)
        else:
            x, a = fn(lp, x)
        aux = aux + a
    return x, aux


def stack_cache_init(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Zeroed decode caches of every layer, in cfg's layout."""
    kinds = _kinds(cfg)
    return _build(lambda i: layer_cache_init(cfg, kinds[i], batch, max_len, dtype, device), cfg)


def stack_decode(params, x, caches, cur_len: int, cfg):
    """One token (x: (B, 1, d_model)) through every layer at position
    ``cur_len``; writes each layer's slot of ``caches`` in place (in the
    stored dtypes) and returns (x, caches)."""
    for lp, cache, kind in zip(_layers(params, cfg), _layers(caches, cfg), _kinds(cfg)):
        x, _ = layer_decode(gather_fsdp(lp), x, cache, cur_len, cfg, kind)
    return x, caches


def _caches_on_mesh(x) -> None:
    """Refuse to make the caches of a prefill on a mesh: their layout is the
    caller's (:func:`repro_torch.parallel.sharding.cache_shardings`), as the
    JAX step's ``out_shardings`` are."""
    if on_mesh(x):
        raise ValueError("a prefill on a mesh fills the caches its caller lays out: "
                         "pass caches=")


def stack_prefill(params, x, positions, cfg, max_len: int, dtype=torch.bfloat16,
                  caches=None):
    """Full-sequence forward that also builds the decode caches (capacity
    ``max_len``; KV caches in ``dtype``), or fills ``caches`` (as
    :func:`stack_cache_init` makes them).  On a mesh the caller lays the
    caches out and passes them.  Returns (x, caches)."""
    if caches is None:
        _caches_on_mesh(x)
        caches = stack_cache_init(cfg, x.shape[0], max_len, dtype, x.device)
    for lp, cache, kind in zip(_layers(params, cfg), _layers(caches, cfg), _kinds(cfg)):
        x = _layer_prefill(gather_fsdp(lp), x, cache, positions, cfg, kind)
    return x, caches
