"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

Counterpart of ``repro/models/ssm.py``.  Full sequences (training, prefill)
run the chunked SSD algorithm: quadratic, attention-like mixing inside
chunks of Q steps and a float32 state (B, H, N, P) passed from chunk to
chunk, O(L·Q) work with one chunk's (B, Q, Q, H) decay weights alive at a
time.  Decode is an O(1) recurrence on that state, so the cache does not
grow with the context.  Plain PyTorch, as the JAX package's block is plain
XLA.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.api import layout, local_call, on_mesh, shard
from .layers import dense_init, rmsnorm, rmsnorm_init


def ssd_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def ssm_init(generator: torch.Generator, cfg) -> Dict:
    """The block's parameters, drawn on the generator's device, under the
    JAX names and scales.  ``A_log`` = log(linspace(1, 16, H)) and
    ``dt_bias`` = softplus⁻¹(1) = log(e - 1) are not drawn: both are
    computed in float64 and rounded once to float32 (XLA's float32
    linspace may give a last bit of its own)."""
    d_inner, H, N = ssd_dims(cfg)
    conv_dim = d_inner + 2 * N
    dev = generator.device
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float64))
    return {
        "in_proj": dense_init(generator, cfg.d_model, 2 * d_inner + 2 * N + H),
        "conv_w": torch.randn((cfg.ssm_conv, conv_dim), generator=generator, device=dev) * 0.1,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": a_log.float().to(dev),
        "D": torch.ones((H,), device=dev),
        "dt_bias": torch.full((H,), math.log(math.e - 1), dtype=torch.float64).float().to(dev),
        "norm": rmsnorm_init(d_inner, dev),
        "out_proj": dense_init(generator, d_inner, cfg.d_model),
    }


def _split_proj(zxbcdt, d_inner: int, N: int, H: int):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    Bm = zxbcdt[..., 2 * d_inner:2 * d_inner + N]
    Cm = zxbcdt[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, x, Bm, Cm, dt


def _causal_conv(x, w, b):
    """Depthwise causal convolution over time, width K, then SiLU.
    x: (B, L, C), w: (K, C).  On a mesh, on each device's batch rows and
    channel shard."""
    if on_mesh(x):
        rows = ("batch", None, "model")
        # the channels split as x's are (the batch may take the model axis first)
        ch = "model" if any(p.is_shard(2) for p in layout(rows, x.shape, x.device_mesh)) \
            else None
        return local_call(_causal_conv, (x, w, b), (rows, (None, ch), (ch,)), (rows,), (x.shape,))
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def _chunk_step(S_prev, xj, Bj, Cj, dtj, dAj, causal):
    """One chunk of the SSD scan: (the state after it, its outputs
    (B, Q, H, P) float32).  ``causal``: the (Q, Q) lower triangle.  Every
    product accumulates in float32, as the JAX einsums'
    ``preferred_element_type`` asks; the intra-chunk weights are rounded to
    the compute dtype first, as there."""
    xf, Bf, Cf = xj.float(), Bj.float(), Cj.float()
    cum = torch.cumsum(dAj, dim=1)                                   # (B, Q, H)
    scores = torch.einsum("bin,bjn->bij", Cf, Bf)
    # the exponent is masked before exp: exp on the i < j branch would
    # overflow and poison the backward through the mask (inf * 0 = NaN)
    diff = cum[:, :, None, :] - cum[:, None, :, :]                   # (B, i, j, H)
    diff = torch.where(causal[None, :, :, None], diff, -1e30)
    w = torch.exp(diff) * scores[..., None] * dtj[:, None, :, :]
    y_intra = torch.einsum("bijh,bjhp->bihp", w.to(xj.dtype).float(), xf)
    y_inter = torch.einsum("bin,bhnp->bihp", Cf, S_prev) * torch.exp(cum)[..., None]
    decay_last = torch.exp(cum[:, -1:, :] - cum)                     # (B, Q, H)
    S_loc = torch.einsum("bjn,bjhp->bhnp", Bf, (decay_last * dtj)[..., None] * xf)
    S_new = S_prev * torch.exp(cum[:, -1])[:, :, None, None] + S_loc
    return S_new, y_intra + y_inter


def _ssd_scan(xh, Bm, Cm, dt, dA, Q: int):
    """The chunk loop of :func:`ssm_apply`: (the outputs (B, L, H, P)
    float32, the last state (B, H, N, P))."""
    B_, L, H, P = xh.shape
    remat = torch.is_grad_enabled()
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    S = torch.zeros((B_, H, Bm.shape[-1], P), dtype=torch.float32, device=xh.device)
    ys = []
    for j in range(0, L, Q):
        args = (S, xh[:, j:j + Q], Bm[:, j:j + Q], Cm[:, j:j + Q], dt[:, j:j + Q],
                dA[:, j:j + Q], causal)
        S, y = checkpoint(_chunk_step, *args, use_reentrant=False) if remat \
            else _chunk_step(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def ssm_apply(p, u: torch.Tensor, cfg, return_cache: bool = False):
    """Full-sequence SSD.  u: (B, L, d_model) -> (B, L, d_model).

    The sequence is padded to a multiple of Q = min(``cfg.ssm_chunk``, L);
    padded steps take dt = -1e9 before the softplus, so dt = 0 and
    dA = 0 there: exact no-ops on the state, which after the last chunk is
    the true last state.  The chunks run in order, each under
    ``torch.utils.checkpoint`` when autograd records (as the JAX scan's
    ``jax.checkpoint``), so the backward keeps one chunk's decay weights at
    a time.  ``return_cache``: also return the decode cache, ``{"conv": the
    last K - 1 pre-conv activations (B, K - 1, d_inner + 2N), "state": the
    last state (B, H, N, P)}``, both float32 (zero rows in front of
    ``conv`` when L < K - 1)."""
    dt_ = u.dtype
    d_inner, H, N = ssd_dims(cfg)
    P = cfg.ssm_head_dim
    B_, L_real, _ = u.shape
    Q = min(cfg.ssm_chunk, L_real)
    pad = (-L_real) % Q
    if pad:
        u = F.pad(u, (0, 0, 0, pad))
    L = L_real + pad

    # on a mesh the packed projection (and its gradient) stays whole along
    # its channels: the five parts it splits into are laid out apart
    zxbcdt = shard(u @ p["in_proj"].to(dt_), "batch", "seq", None)
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, d_inner, N, H)
    if pad:
        live = (torch.arange(L, device=u.device) < L_real)[None, :, None]
        dt = torch.where(live, dt, -1e9)   # softplus(-1e9) = 0
    xbc_raw = torch.cat([x, Bm, Cm], dim=-1)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    x, Bm, Cm = xbc[..., :d_inner], xbc[..., d_inner:d_inner + N], xbc[..., d_inner + N:]

    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B, L, H)
    dA = dt * -torch.exp(p["A_log"])
    xh = x.reshape(B_, L, H, P)

    if on_mesh(xh):   # each device scans its batch (and head) shard
        heads, rows = ("batch", None, "model", None), ("batch", None, None)
        y, S = local_call(functools.partial(_ssd_scan, Q=Q), (xh, Bm, Cm, dt, dA),
                          (heads, rows, rows, heads[:3], heads[:3]),
                          (heads, ("batch", "model", None, None)),
                          ((B_, L, H, P), (B_, H, N, P)))
    else:
        y, S = _ssd_scan(xh, Bm, Cm, dt, dA, Q)                        # (B, L, H, P) f32
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B_, L, d_inner).to(dt_)

    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    y = shard(y, "batch", "seq", "model")
    out = shard((y @ p["out_proj"].to(dt_))[:, :L_real], "batch", "seq", None)
    if return_cache:
        K = cfg.ssm_conv
        tail = xbc_raw[:, max(L_real - (K - 1), 0):L_real, :].float()
        if tail.shape[1] < K - 1:
            tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
        return out, {"conv": tail, "state": S}
    return out


# ---------------------------------------------------------------------------
# decode (an O(1) recurrence a token)
# ---------------------------------------------------------------------------

def ssm_cache_init(batch: int, cfg, dtype=torch.float32, device=None) -> Dict:
    d_inner, H, N = ssd_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * N), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, H, N, cfg.ssm_head_dim), dtype=dtype, device=device)}


def ssm_decode(p, u: torch.Tensor, cache: Dict, cfg) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrence.  u: (B, 1, d_model).  Writes the new state and
    conv window into ``cache``'s tensors (in their dtypes) and returns
    (out (B, 1, d_model), cache)."""
    dt_ = u.dtype
    d_inner, H, N = ssd_dims(cfg)
    P = cfg.ssm_head_dim

    zxbcdt = u[:, 0] @ p["in_proj"].to(dt_)                           # (B, proj)
    z, x, Bm, Cm, dt = _split_proj(zxbcdt, d_inner, N, H)
    xbc_new = torch.cat([x, Bm, Cm], dim=-1)                          # (B, conv_dim)
    conv_buf = torch.cat([cache["conv"], xbc_new[:, None].to(cache["conv"].dtype)], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_buf.to(dt_), p["conv_w"].to(dt_))
                 + p["conv_b"].to(dt_))
    x, Bm, Cm = xbc[..., :d_inner], xbc[..., d_inner:d_inner + N], xbc[..., d_inner + N:]

    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B, H)
    da = torch.exp(dt * -torch.exp(p["A_log"]))
    xh = x.reshape(-1, H, P).float()
    state = (cache["state"].float() * da[:, :, None, None]
             + Bm.float()[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(-1, d_inner).to(dt_)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = shard((y @ p["out_proj"].to(dt_))[:, None, :], "batch", "seq", None)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_buf[:, 1:])
    return out, cache
