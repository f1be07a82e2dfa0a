"""Whisper-style encoder-decoder backbone, its audio front end a stub.

Counterpart of ``repro/models/whisper.py``.  The conv / mel front end is a
stub: the batch gives precomputed frame embeddings (B, n_audio_frames,
d_model).  The encoder is bidirectional self-attention, the decoder causal
self-attention then cross-attention over the encoder states, each block
behind a LayerNorm, with sinusoidal positions computed on the fly.

Two parameter layouts, as in the JAX package: stacked (``{"stacked": ...}``
with a leading layer axis) under ``cfg.scan_layers``, per layer
(``{"layer_i": ...}``) otherwise.  The JAX package scans over the stacked
axis; the port loops over views of its slices
(:func:`repro_torch.models.transformer._layers`), and ``cfg.remat``
recomputes each layer in the backward (``torch.utils.checkpoint``,
non-reentrant, as ``jax.checkpoint``).  A stacked tree is allocated once
and each layer's draw written into its slice.  The decode caches take the
decoder's layout: each layer's self-attention KV cache (``k``, ``v``) and
its cross K/V over the encoder states (``ck``, ``cv``), all in the cache
dtype; :func:`decoder_decode` updates them in place.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.api import gather_fsdp, local_call, on_mesh, psum, shard, write_local
from . import attention as A
from . import layers as L
from . import transformer as T

_F32 = np.float32
#: Cephes' split of ln 2 and its degree-5 polynomial for exp on [-ln2/2, ln2/2]
_LN2_HI, _LN2_LO = _F32(0.693359375), _F32(-2.12194440e-4)
_EXP_POLY = tuple(_F32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def _fma(a, b, c):
    """float32 a·b + c rounded once (a float32 product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(_F32)


def _exp_f32(x: np.ndarray) -> np.ndarray:
    """exp of float32 ``x`` as XLA's CPU backend computes it: x = n·ln 2 + r
    with n = floor(x·log2 e + 1/2), Cephes' polynomial in r, fused
    multiply-adds.  A correctly rounded exp is an ulp away from it at some
    of the sinusoid's frequencies, and an ulp of a frequency is 1e-4 rad of
    angle at position 1,499."""
    x = np.clip(x.astype(_F32), _F32(-87.8), _F32(88.8))
    n = np.floor(x * _F32(1.44269504088896341) + _F32(0.5)).astype(_F32)
    r = _fma(-n, _LN2_LO, _fma(-n, _LN2_HI, x))
    y = _EXP_POLY[0]
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + _F32(1)
    return (y * np.ldexp(_F32(1), n.astype(np.int32))).astype(_F32)


@functools.lru_cache(maxsize=None)
def _host_freqs(d: int) -> np.ndarray:
    half = d // 2
    arg = _F32(-math.log(10000.0)) * np.arange(half, dtype=_F32) / _F32(max(half - 1, 1))
    return _exp_f32(arg)


def _freqs(d: int, device: torch.device) -> torch.Tensor:
    """The (d // 2,) float32 frequencies exp(-ln(1e4)·i / max(d/2 - 1, 1)),
    made on the host once and moved to a device once; under a
    ``FakeTensorMode`` (the dry run) made anew, as a fake tensor belongs to
    the mode that made it and a real one is refused there."""
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        return torch.from_numpy(_host_freqs(d)).to(device)
    return _device_freqs(d, device)


@functools.lru_cache(maxsize=None)
def _device_freqs(d: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):   # a tensor autograd may meet later
        return torch.from_numpy(_host_freqs(d)).to(device)


def sinusoid(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """(S,) positions -> (S, d) [sin | cos] embeddings, computed in float32
    in the JAX function's order and cast to ``dtype`` last."""
    ang = positions[:, None].float() * _freqs(d, positions.device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_cfg(cfg):
    """cfg with the encoder's depth as ``n_layers``: the layout helpers'
    view of the encoder stack."""
    return cfg.replace(n_layers=cfg.n_enc_layers)


def enc_layer_init(generator: torch.Generator, cfg):
    dev = generator.device
    return {"ln1": L.layernorm_init(cfg.d_model, dev),
            "attn": A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
            "ln2": L.layernorm_init(cfg.d_model, dev),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act)}


def dec_layer_init(generator: torch.Generator, cfg):
    dev = generator.device
    return {"ln1": L.layernorm_init(cfg.d_model, dev),
            "attn": A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
            "ln2": L.layernorm_init(cfg.d_model, dev),
            "cross": A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
            "ln3": L.layernorm_init(cfg.d_model, dev),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act)}


def _run(body, layers, x, cfg):
    """``x = body(lp, x)`` over the layers' trees, each under
    ``checkpoint`` when ``cfg.remat``."""
    for lp in layers:
        lp = gather_fsdp(lp)
        x = shard(x, "batch", "residual", None)
        x = checkpoint(body, lp, x, use_reentrant=False) if cfg.remat else body(lp, x)
    return x


def _enc_layer_apply(lp, h, pos, cfg):
    h = shard(h, "batch", "seq", None)   # the sequence-parallel residual, gathered
    h = h + A.attention(lp["attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps), pos,
                        rope_theta=None, causal=False)
    return h + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], h, cfg.norm_eps), cfg.act)


def encoder_apply(params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, F, d_model) stubbed embeddings -> encoder states."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames + sinusoid(pos, cfg.d_model, frames.dtype)
    return _run(lambda lp, h: _enc_layer_apply(lp, h, pos, cfg),
                T._layers(params, _enc_cfg(cfg)), x, cfg)


def dec_layer_apply(lp, h, enc, pos, enc_pos, cfg):
    h = shard(h, "batch", "seq", None)   # the sequence-parallel residual, gathered
    h = h + A.attention(lp["attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps), pos,
                        rope_theta=None, causal=True)
    h = h + A.attention(lp["cross"], L.layernorm(lp["ln2"], h, cfg.norm_eps), pos,
                        rope_theta=None, kv_x=enc, kv_positions=enc_pos)
    return h + L.mlp(lp["mlp"], L.layernorm(lp["ln3"], h, cfg.norm_eps), cfg.act)


def decoder_apply(params, tokens_emb: torch.Tensor, enc: torch.Tensor, cfg) -> torch.Tensor:
    pos = torch.arange(tokens_emb.shape[1], device=tokens_emb.device)
    enc_pos = torch.arange(enc.shape[1], device=enc.device)
    x = tokens_emb + sinusoid(pos, cfg.d_model, tokens_emb.dtype)
    return _run(lambda lp, h: dec_layer_apply(lp, h, enc, pos, enc_pos, cfg),
                T._layers(params, cfg), x, cfg)


def init(generator: torch.Generator, cfg):
    """The encoder-decoder's parameter tree, under the JAX tree's names
    (``cfg.vocab`` rows of the tied embedding: the caller pads it)."""
    dev = generator.device
    return {"enc": T._build(lambda i: enc_layer_init(generator, cfg), _enc_cfg(cfg)),
            "dec": T._build(lambda i: dec_layer_init(generator, cfg), cfg),
            "embed": L.embed_init(generator, cfg.vocab, cfg.d_model),
            "ln_enc": L.layernorm_init(cfg.d_model, dev),
            "ln_out": L.layernorm_init(cfg.d_model, dev)}


def _cross_kv(lp, enc):
    """A decoder layer's cross K and V over the encoder states, in their dtype."""
    k = torch.einsum("bsd,dhk->bshk", enc, lp["cross"]["wk"].to(enc.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc, lp["cross"]["wv"].to(enc.dtype))
    return k, v


def _dec_cache(cfg, batch: int, max_len: int, frames: int, dtype, device):
    cache = A.cache_init(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, device)
    shape = (batch, frames, cfg.n_kv_heads, cfg.hd)
    return {**cache, "ck": torch.empty(shape, dtype=dtype, device=device),
            "cv": torch.empty(shape, dtype=dtype, device=device)}


def decoder_prefill(params, tokens_emb: torch.Tensor, enc: torch.Tensor, cfg, max_len: int,
                    dtype=torch.bfloat16, caches=None):
    """Decoder forward over the prompt that also fills each layer's
    self-attention cache (capacity ``max_len``) and cross K/V, in
    ``dtype``, made here or given as ``caches`` (as made here; on a mesh
    the caller lays them out and passes them).  ``params`` is the whole tree.  The cross-attention runs on
    the K/V the cache stores before their cast (the JAX function computes
    them twice, in the same dtype).  Returns (x, caches)."""
    B, S = tokens_emb.shape[:2]
    if S > max_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a KV cache of {max_len} slots "
                         f"(max_len)")
    dev = tokens_emb.device
    pos = torch.arange(S, device=dev)
    enc_pos = torch.arange(enc.shape[1], device=dev)
    x = tokens_emb + sinusoid(pos, cfg.d_model, tokens_emb.dtype)
    if caches is None:
        T._caches_on_mesh(x)
        caches = T._build(lambda i: _dec_cache(cfg, B, max_len, enc.shape[1], dtype, dev), cfg)
    for lp, cache in zip(T._layers(params["dec"], cfg), T._layers(caches, cfg)):
        lp = gather_fsdp(lp)
        dt = x.dtype
        q, k, v = A.qkv(lp["attn"], L.layernorm(lp["ln1"], x, cfg.norm_eps), pos, None)
        out = A.blocked_attention(q, k, v, pos, pos, causal=True)
        x = x + shard(torch.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"].to(dt)),
                      "batch", "seq", None)
        ck, cv = _cross_kv(lp, enc)
        if on_mesh(k):
            for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
                write_local(cache[name], t, 1)
        else:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            cache["ck"].copy_(ck)
            cache["cv"].copy_(cv)
        q = torch.einsum("bsd,dhk->bshk", L.layernorm(lp["ln2"], x, cfg.norm_eps),
                         lp["cross"]["wq"].to(dt))
        out = A.blocked_attention(q, ck, cv, pos, enc_pos, causal=False)
        x = x + shard(torch.einsum("bshk,hkd->bsd", out, lp["cross"]["wo"].to(dt)),
                      "batch", "seq", None)
        x = x + L.mlp(lp["mlp"], L.layernorm(lp["ln3"], x, cfg.norm_eps), cfg.act)
    return x, caches


# ---------------------------------------------------------------------------
# decode path (cached)
# ---------------------------------------------------------------------------

@torch.no_grad()
def dec_cache_init(params, enc: torch.Tensor, cfg, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> Dict:
    """Zeroed self-attention KV caches and each layer's cross K/V over
    ``enc``, in the decoder's layout.  ``params`` is the whole tree."""
    layers = T._layers(params["dec"], cfg)

    def one(i):
        k, v = _cross_kv(layers[i], enc)
        return {**A.cache_init(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, enc.device),
                "ck": k.to(dtype), "cv": v.to(dtype)}

    return T._build(one, cfg)


def dec_layer_decode(lp, h, cache, cur_len: int, cfg):
    """One token through one decoder layer; writes its self-attention
    slot in place.  The cross-attention attends over every cached frame,
    unmasked: q / √D cast to the cache's dtype, the scores and the weighted
    sum float32 products of the cache upcast, the weights cast to ``cv``'s
    dtype first."""
    a, cache = A.decode_attention(lp["attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps), cache,
                                  cur_len, rope_theta=None)
    h = h + a
    dt = h.dtype
    q = torch.einsum("bsd,dhk->bshk", L.layernorm(lp["ln2"], h, cfg.norm_eps),
                     lp["cross"]["wq"].to(dt))
    if on_mesh(q):
        o = _cross_on_mesh(q, cache["ck"], cache["cv"])
    else:
        o = _cross_core(q, cache["ck"], cache["cv"], q.shape[-1])
    h = h + shard(torch.einsum("bshk,hkd->bsd", o, lp["cross"]["wo"].to(dt)),
                  "batch", "seq", None)
    h = h + L.mlp(lp["mlp"], L.layernorm(lp["ln3"], h, cfg.norm_eps), cfg.act)
    return h, cache


def _cross_core(q, ck, cv, D: int, reduce=None):
    """The decode step's cross-attention of q (B, 1, H, D') over the cached
    ``ck``, ``cv``: (B, 1, H, D') in q's dtype.  ``D``: the head dim the
    scores are scaled by; ``reduce``: the sum of the scores over the
    devices that split the head dim (D' = D without one)."""
    B, _, H, Dl = q.shape
    KV = ck.shape[2]
    qf = (q / math.sqrt(D)).to(ck.dtype).reshape(B, KV, H // KV, Dl).float()
    s = torch.einsum("bkgd,bckd->bkgc", qf, ck.float())
    w = torch.softmax(s if reduce is None else reduce(s), dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", w.to(cv.dtype).float(), cv.float())
    return o.reshape(B, 1, H, Dl).to(q.dtype)


def _cross_on_mesh(q, ck, cv):
    """:func:`_cross_core` on each device's shards of the cross K/V: by
    head, or by head dim, the scores then summed over the devices that
    split it."""
    mesh = q.device_mesh
    if any(p.is_shard(1) for p in ck.placements):
        raise NotImplementedError("cross-attention decode over cross K/V sharded along "
                                  "the frames")
    hd_axes = tuple(i for i, p in enumerate(ck.placements) if p.is_shard(3))
    names = ("batch", None, None, "model") if hd_axes else ("batch", None, "model", None)
    reduce = functools.partial(psum, mesh=mesh, axes=hd_axes) if hd_axes else None
    o = local_call(functools.partial(_cross_core, D=q.shape[-1], reduce=reduce),
                   (q, ck, cv), (names, ..., ...), (names,), (q.shape,))
    return shard(o, "batch", "seq", None, None)   # whole heads for the output projection


def decoder_decode(params, x, caches, cur_len: int, cfg):
    """One token (x: (B, 1, d_model)) through the decoder at position
    ``cur_len``; writes each layer's slot of ``caches`` in place and
    returns (x, caches).  ``params`` is the whole tree."""
    x = x + sinusoid(torch.full((1,), cur_len, device=x.device), cfg.d_model, x.dtype)
    for lp, cache in zip(T._layers(params["dec"], cfg), T._layers(caches, cfg)):
        x, _ = dec_layer_decode(gather_fsdp(lp), x, cache, cur_len, cfg)
    return x, caches
