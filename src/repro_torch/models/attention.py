"""GQA attention over full sequences: the blocked (streaming-softmax)
training path.

Counterpart of the full-sequence half of ``repro/models/attention.py``.  The
path streams over KV chunks with an online softmax, so no more than
(B, S, H, chunk) scores exist at once.  It is plain PyTorch, as the JAX
package's is plain XLA (no Pallas kernel); no library attention is called.
The cached decode paths (``cache_init``, ``decode_attention``) wait for
ROADMAP item 8b.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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
    """
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
    out = blocked_attention(q, k, v, positions, kv_pos,
                            causal=causal, window=window, chunk=chunk)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
