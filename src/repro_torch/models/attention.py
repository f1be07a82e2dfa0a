"""GQA attention: the blocked (streaming-softmax) path over full sequences
and the cached decode paths.

Counterpart of ``repro/models/attention.py``.  The training / prefill path
streams over KV chunks with an online softmax, so no more than
(B, S, H, chunk) scores exist at once.  Decode attends one token against a
full preallocated KV cache or a sliding-window ring cache (RecurrentGemma's
local attention: O(window) memory at any context length), and writes the
token's K and V into the cache in place.  It is plain PyTorch, as the JAX
package's is plain XLA (no Pallas kernel); no library attention is called.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from ..parallel.api import layout, local_call, on_mesh, psum, shard, shard_index
from .layers import apply_rope, dense_init

NEG_INF = -1e30


def attn_init(generator: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, qkv_bias: bool = False):
    p = {
        "wq": dense_init(generator, d_model, n_heads * head_dim).reshape(
            d_model, n_heads, head_dim),
        "wk": dense_init(generator, d_model, n_kv * head_dim).reshape(
            d_model, n_kv, head_dim),
        "wv": dense_init(generator, d_model, n_kv * head_dim).reshape(
            d_model, n_kv, head_dim),
        "wo": dense_init(generator, n_heads * head_dim, d_model).reshape(
            n_heads, head_dim, d_model),
    }
    if qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((n_heads, head_dim), device=dev)
        p["bk"] = torch.zeros((n_kv, head_dim), device=dev)
        p["bv"] = torch.zeros((n_kv, head_dim), device=dev)
    return p


def qkv(p, x, positions, rope_theta: Optional[float]):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Streaming-softmax attention.

    q: (B, S, H, D); k, v: (B, Skv, KV, D); GQA by head grouping.
    q_pos: (S,), kv_pos: (Skv,).  window > 0 limits to local attention.
    q is scaled by 1/√D and cast back to its dtype; the scores and the P·V
    products accumulate in float32 (each chunk of K, V cast to float32, as
    ``preferred_element_type`` asks in the JAX function), and P is cast to
    V's dtype first.  Padded keys carry position -1e9 and masked scores
    -1e30.

    On a mesh (DTensors under sharding rules) it runs on each device's
    batch and head shards (:func:`_local_heads`).
    """
    if on_mesh(q):
        # the KV sequence stays whole: a device slices its chunks locally
        k = shard(k, "batch", None, "model", None)
        v = shard(v, "batch", None, "model", None)
        names = ("batch", "seq", "model", None)
        axes = tuple(i for i, p in enumerate(layout(names, q.shape, q.device_mesh))
                     if p.is_shard(2))
        fn = functools.partial(_local_heads, blocked_attention, q.device_mesh,
                               (q.shape[2], k.shape[2], axes),
                               causal=causal, window=window, chunk=chunk)
        return local_call(fn, (q, k, v, q_pos, kv_pos),
                          (("batch", "seq", "model", None), ("batch", None, "model", None),
                           ("batch", None, "model", None), None, None),
                          (("batch", "seq", "model", None),), (q.shape,))
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-10 ** 9)
    n_chunks = (Skv + pad) // chunk
    qs = (q / math.sqrt(D)).to(q.dtype).reshape(B, S, KV, G, D).float()

    m = torch.full((B, S, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((B, S, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, KV, G, D), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        kj, vj, pj = k[:, sl], v[:, sl], kv_pos[sl]
        s = torch.einsum("bskgd,bckd->bskgc", qs, kj.float())
        mask = pj[None, :] >= 0
        if causal:
            mask = mask & (pj[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (pj[None, :] > q_pos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p_ = torch.exp(s - m_new[..., None])
        lsum = lsum * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bskgc,bckd->bskgd", p_.to(v.dtype).float(), vj.float())
        m = m_new
    out = acc / torch.clamp_min(lsum[..., None], 1e-30)
    return out.reshape(B, S, H, D).to(q.dtype)


def _local_heads(core, mesh, heads, q, k, v, *args, **kwargs):
    """``core`` on one device's shards.  ``heads``: (H, KV, the mesh axes
    the query heads are split over).  Where the KV heads could not be split
    as the query heads are (fewer KV heads than devices on those axes),
    each device keeps the KV heads its query heads read."""
    H, KV, axes = heads
    Hl, KVl = q.shape[-2], k.shape[-2]
    if Hl < H and KVl == KV and KV > 1:
        G = H // KV
        lo = shard_index(mesh, axes) * Hl
        first, last = lo // G, (lo + Hl - 1) // G
        k, v = k[..., first:last + 1, :], v[..., first:last + 1, :]
    return core(q, k, v, *args, **kwargs)


def attention(p, x, positions, *, rope_theta, causal=True, window=0,
              kv_x: Optional[torch.Tensor] = None, kv_positions=None,
              chunk: int = 1024):
    """Self or cross attention over full sequences (train / prefill)."""
    dt = x.dtype
    if kv_x is None:
        q, k, v = qkv(p, x, positions, rope_theta)
        kv_pos = positions
    else:  # cross attention: KV from encoder states, no rope on cross
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
        k = torch.einsum("bsd,dhk->bshk", kv_x, p["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", kv_x, p["wv"].to(dt))
        kv_pos = kv_positions
        causal = False
    q = shard(q, "batch", "seq", "model", None)
    k = shard(k, "batch", "seq", "model", None)
    out = blocked_attention(q, k, v, positions, kv_pos,
                            causal=causal, window=window, chunk=chunk)
    out = shard(out, "batch", "seq", "model", None)
    return shard(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), "batch", "seq", None)


# ---------------------------------------------------------------------------
# decode with caches
# ---------------------------------------------------------------------------

def cache_init(batch: int, max_len: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """Full preallocated KV cache (a position's slot is its index)."""
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def window_cache_init(batch: int, window: int, n_kv: int, head_dim: int,
                      dtype=torch.bfloat16, device=None) -> Dict:
    """Sliding-window ring cache: position p lives at slot p % window;
    ``pos`` (int32) holds each slot's position, -10**9 while empty."""
    shape = (batch, window, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((window,), -10 ** 9, dtype=torch.int32, device=device)}


def decode_attention(p, x, cache: Dict, cur_len: int, *, rope_theta, window: int = 0):
    """One-token attention against a cache.  x: (B, 1, d_model); cur_len:
    the token's position, a Python int.

    Writes the token's K and V (in the cache's dtype) into ``cache`` in
    place, at slot ``cur_len`` of a full cache or ``cur_len % window`` of a
    ring, and returns (out (B, 1, d_model), cache).  A ring slot is valid
    where 0 <= pos <= cur_len and pos > cur_len - window.  The scores and
    the weighted sum are float32 products of the cache's values upcast (the
    JAX function's ``preferred_element_type=float32``); a full cache
    attends over its first cur_len + 1 slots only, the slots the JAX
    function's mask leaves valid.
    """
    dt = x.dtype
    q, k, v = qkv(p, x, torch.full((1,), cur_len, device=x.device), rope_theta)
    if on_mesh(q):
        out = _decode_on_mesh(q, k, v, cache, cur_len, window)
    else:
        out = _decode_core(q, k, v, cache["k"], cache["v"], cache.get("pos"), cur_len, window)
    return shard(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), "batch", "seq", None), cache


def _decode_core(q, k, v, ck, cv, pos, cur_len: int, window: int):
    """The cache write and the attention of :func:`decode_attention`:
    (out (B, 1, H, D) in q's dtype)."""
    dt = q.dtype
    if window:
        slot = cur_len % window
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        pos[slot] = cur_len
        valid = (pos >= 0) & (pos <= cur_len) & (pos > cur_len - window)
    else:
        ck[:, cur_len] = k[:, 0]
        cv[:, cur_len] = v[:, 0]
        ck, cv = ck[:, :cur_len + 1], cv[:, :cur_len + 1]
        valid = None

    B, _, H, D = q.shape
    KV = ck.shape[2]
    G = H // KV
    qf = (q / math.sqrt(D)).to(ck.dtype).reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bckd->bkgc", qf, ck.float())
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", w.to(cv.dtype).float(), cv.float())
    return out.reshape(B, 1, H, D).to(dt)


def _decode_on_mesh(q, k, v, cache: Dict, cur_len: int, window: int):
    """:func:`_decode_core` on each device's batch and head shards, its
    cache shards written in place; where the cache is sharded along its
    sequence instead (KV heads that do not divide the model axis),
    :func:`_decode_seq_shards`."""
    mesh = q.device_mesh
    seq_axes = [i for i, p in enumerate(cache["k"].placements) if p.is_shard(1)]
    pos = cache.get("pos")
    if seq_axes:
        rows = ("batch", None, None, None)
        fn = functools.partial(_decode_seq_shards, mesh=mesh, axes=tuple(seq_axes),
                               cur_len=cur_len, window=window)
        args = (q, k, v, cache["k"], cache["v"]) + ((pos,) if pos is not None else ())
        return local_call(fn, args, (rows, rows, rows) + (...,) * (len(args) - 3),
                          (rows,), (q.shape,))
    heads = ("batch", "seq", "model", None)

    def core(q, k, v, ck, cv, *pos_):
        return _decode_core(q, k, v, ck, cv, pos_[0] if pos_ else None, cur_len, window)

    args = (q, k, v, cache["k"], cache["v"]) + ((pos,) if pos is not None else ())
    return local_call(core, args, (heads, heads, heads) + (...,) * (len(args) - 3),
                      (heads,), (q.shape,))


def _decode_seq_shards(q, k, v, ck, cv, *pos, mesh, axes, cur_len: int, window: int):
    """One device's decode attention over its slice of the cache's
    positions (flash-decoding): it writes the new token's K and V where its
    slot falls in the slice, scores its slots, and the softmax's maximum
    and the weighted sums are reduced over the devices that share the
    sequence.  q, k, v: this device's batch rows, every head."""
    S_l = ck.shape[1]
    lo = shard_index(mesh, axes) * S_l
    slot = cur_len % window if window else cur_len
    if lo <= slot < lo + S_l:
        ck[:, slot - lo] = k[:, 0]
        cv[:, slot - lo] = v[:, 0]
    if window:
        pos[0][slot] = cur_len
        kv_pos = pos[0][lo:lo + S_l]
    else:
        kv_pos = torch.arange(lo, lo + S_l, device=ck.device)
    valid = (kv_pos >= 0) & (kv_pos <= cur_len) & (kv_pos > cur_len - window if window else True)
    B, _, H, D = q.shape
    KV = ck.shape[2]
    qf = (q / math.sqrt(D)).to(ck.dtype).reshape(B, KV, H // KV, D).float()
    s = torch.where(valid, torch.einsum("bkgd,bckd->bkgc", qf, ck.float()), NEG_INF)
    m = psum(s.amax(dim=-1), mesh, axes, "max")
    w = torch.exp(s - m[..., None])
    lsum = psum(w.sum(dim=-1), mesh, axes)
    acc = psum(torch.einsum("bkgc,bckd->bkgd", w.to(cv.dtype).float(), cv.float()), mesh, axes)
    return (acc / lsum[..., None]).reshape(B, 1, H, D).to(q.dtype)
