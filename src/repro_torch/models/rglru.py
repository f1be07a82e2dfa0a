"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

Counterpart of ``repro/models/rglru.py``.  Temporal mixing:
h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t), with
a_t = exp(-c·softplus(Λ)·r_t) and r, i input-dependent sigmoid gates.
Full sequences (training, prefill) run a chunked scan; decode is an O(1)
recurrence on a float32 state, so the hybrid family serves contexts of any
length.  Plain PyTorch, as the JAX package's is plain XLA.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init

_C = 8.0


def rglru_init(generator: torch.Generator, cfg) -> Dict:
    """The block's parameters, drawn on the generator's device.  ``lam``
    (Λ) is not drawn: Λ = log(expm1(-log(a) / c)) for a evenly spaced in
    [0.9, 0.999] (the Griffin appendix), computed in float64 and rounded
    once to float32 (XLA's float32 linspace and transcendentals may give a
    last bit of their own)."""
    D, W = cfg.d_model, cfg.lru_width
    dev = generator.device
    a = torch.linspace(0.9, 0.999, W, dtype=torch.float64)
    return {
        "w_x": dense_init(generator, D, W),
        "w_y": dense_init(generator, D, W),
        "conv_w": torch.randn((4, W), generator=generator, device=dev) * 0.1,
        "conv_b": torch.zeros((W,), device=dev),
        "w_a": dense_init(generator, W, W, scale=0.02),
        "b_a": torch.zeros((W,), device=dev),
        "w_i": dense_init(generator, W, W, scale=0.02),
        "b_i": torch.zeros((W,), device=dev),
        "lam": torch.log(torch.expm1(-torch.log(a) / _C)).float().to(dev),
        "w_out": dense_init(generator, W, D),
    }


def _gates(p, x):
    """(a, gated) in float32 from the conv output x (B, ..., W)."""
    dt = x.dtype
    r = torch.sigmoid(x @ p["w_a"].to(dt) + p["b_a"].to(dt))
    i = torch.sigmoid(x @ p["w_i"].to(dt) + p["b_i"].to(dt))
    log_a = (-_C * F.softplus(p["lam"])) * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i.float() * x.float())
    return a, gated


def _conv(x, w, b):
    """Causal depthwise convolution over time, width ``w.shape[0]``."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K)) + b


def rglru_apply(p, u: torch.Tensor, cfg, return_cache: bool = False, chunk: int = 64):
    """Full-sequence recurrent block.  u: (B, L, d_model).

    The scan is sequential over chunks of ``chunk`` steps, with masked
    log-decay weights within a chunk (every exponent <= 0, so every weight
    is at most 1): O(L·chunk) work and one chunk's (B, chunk, chunk, W)
    weights alive at a time (autograd keeps each chunk's for the backward).
    Padded steps (log a = 0, input 0) are exact no-ops, so the state after
    the last chunk is the true last state.  ``return_cache``: also return
    the decode cache, ``{"h": last state (B, W) float32, "conv": the last
    three pre-conv activations (B, 3, W) float32}`` (zero rows in front
    when L < 3).
    """
    dt = u.dtype
    x_raw = u @ p["w_x"].to(dt)
    x = _conv(x_raw, p["conv_w"].to(dt), p["conv_b"].to(dt))
    y = F.gelu(u @ p["w_y"].to(dt), approximate="tanh")

    a, gated = _gates(p, x)                      # (B, L, W) float32
    log_a = torch.log(torch.clamp_min(a, 1e-37))

    B, L, W = gated.shape
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        gated = F.pad(gated, (0, 0, 0, pad))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    hc = torch.zeros((B, W), dtype=torch.float32, device=u.device)
    hs = []
    for j in range(0, L + pad, Q):
        cum = torch.cumsum(log_a[:, j:j + Q], dim=1)              # (B, Q, W), <= 0
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B, Q, Q, W)
        diff = torch.where(causal[None, :, :, None], diff, -1e30)
        h = torch.einsum("btjw,bjw->btw", torch.exp(diff), gated[:, j:j + Q])
        h = h + torch.exp(cum) * hc[:, None, :]
        hc = h[:, -1, :]
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :L].to(dt)
    out = (h * y) @ p["w_out"].to(dt)
    if return_cache:
        tail = x_raw[:, max(0, L - 3):, :].float()
        if tail.shape[1] < 3:
            tail = F.pad(tail, (0, 0, 3 - tail.shape[1], 0))
        return out, {"h": hc, "conv": tail}
    return out


def rglru_cache_init(batch: int, cfg, dtype=torch.float32, device=None) -> Dict:
    return {"h": torch.zeros((batch, cfg.lru_width), dtype=dtype, device=device),
            "conv": torch.zeros((batch, 3, cfg.lru_width), dtype=dtype, device=device)}


def rglru_decode(p, u: torch.Tensor, cache: Dict, cfg) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence.  u: (B, 1, d_model).  Writes the new state and
    conv window into ``cache``'s tensors (in their dtypes) and returns
    (out (B, 1, d_model), cache)."""
    dt = u.dtype
    x_new = u[:, 0] @ p["w_x"].to(dt)                                  # (B, W)
    buf = torch.cat([cache["conv"].to(dt), x_new[:, None]], dim=1)     # (B, 4, W)
    x = torch.einsum("bkc,kc->bc", buf, p["conv_w"].to(dt)) + p["conv_b"].to(dt)
    y = F.gelu(u[:, 0] @ p["w_y"].to(dt), approximate="tanh")
    a, gated = _gates(p, x)
    h = a * cache["h"] + gated
    out = ((h.to(dt) * y) @ p["w_out"].to(dt))[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(buf[:, 1:])
    return out, cache
