"""Shared model building blocks, in the JAX package's functional style.

Counterpart of ``repro/models/layers.py``.  Parameters are nested dicts of
tensors (a :class:`repro_torch.models.params.ParamTree` hands its
parameters out as one); every constructor is ``*_init(generator, ...)``,
drawing on the generator's device, and every application a function of the
dict and its inputs.  Activations carry the JAX package's ``shard``
annotations by logical axis names (:mod:`repro_torch.parallel.api`), the
identity outside a sharding-rules context.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.api import layout, local_call, on_mesh, psum, shard, shard_index


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=generator,
                       device=generator.device) * scale


def rmsnorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"]).to(dt)


def layernorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), device=device), "bias": torch.zeros((d,), device=device)}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) or (S,).  Half-split rotation
    (not interleaved), angles in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                  # (D/2,)
    ang = positions[..., None].float() * freqs                     # (B, S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, act: str):
    if act == "relu2":  # squared-ReLU, 2-matrix MLP (nemotron)
        return {"w_in": dense_init(generator, d_model, d_ff),
                "w_out": dense_init(generator, d_ff, d_model)}
    return {"w_gate": dense_init(generator, d_model, d_ff),
            "w_up": dense_init(generator, d_model, d_ff),
            "w_out": dense_init(generator, d_ff, d_model)}


def mlp(p, x, act: str):
    """The weights are cast to the activations' dtype; gelu is the tanh
    approximation (``jax.nn.gelu``'s default).  On a mesh the output is
    reduced over the tensor-parallel shards (as every block's output is)."""
    dt = x.dtype
    if act == "relu2":
        h = torch.square(F.relu(x @ p["w_in"].to(dt)))
    else:
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        h = g * u
    h = shard(h, "batch", "seq", "model")
    return shard(h @ p["w_out"].to(dt), "batch", "seq", None)   # whole on a mesh's model axis


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def embed_init(generator: torch.Generator, vocab: int, d_model: int):
    return {"table": torch.randn((vocab, d_model), generator=generator,
                                 device=generator.device) * 0.02}


def embed(p, tokens, dtype):
    if on_mesh(p["table"]):
        return _vocab_parallel_embed(p["table"], tokens, dtype)
    return p["table"].to(dtype)[tokens]


def _vocab_parallel_embed(table, tokens, dtype):
    """The rows of ``tokens`` from a vocab-sharded table, each device over
    its batch rows and its vocab shard: the rows it holds, zeros for the
    others, summed over the devices that split the vocab."""
    mesh = table.device_mesh
    vax = tuple(i for i, p in enumerate(table.placements) if p.is_shard(0))

    def core(tab, tok):
        V = tab.shape[0]
        lo = shard_index(mesh, vax) * V
        mine = (tok >= lo) & (tok < lo + V)
        rows = tab.to(dtype)[torch.clamp(tok - lo, 0, V - 1)]
        return psum(torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype,
                                                                    device=rows.device)),
                    mesh, vax)

    names = ("batch", "seq")[:tokens.ndim]
    return local_call(core, (table, tokens), (..., names), (names + (None,),),
                      (tuple(tokens.shape) + (table.shape[1],),))


def unembed(p, x):
    return shard(x @ p["table"].to(x.dtype).T, "batch", "seq", "model")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with the optional z-loss, in float32."""
    logits = logits.float()
    if on_mesh(logits):
        lse, ll = _vocab_parallel_lse(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.mean()


def _vocab_parallel_lse(logits, labels):
    """The log-normaliser and the label's logit of vocab-sharded logits
    (B, S, V), each device over its vocab shard: the maximum, the sum of
    exponentials and the label's logit reduced over the devices that split
    the vocab.  Both (B, S), laid out by batch."""
    mesh = logits.device_mesh
    names = ("batch", "seq", "model")
    vax = tuple(i for i, p in enumerate(layout(names, logits.shape, mesh)) if p.is_shard(2))

    def core(lg, lab):
        V = lg.shape[-1]
        lo = shard_index(mesh, vax) * V
        m = psum(lg.detach().amax(dim=-1), mesh, vax, "max")
        lse = m + torch.log(psum(torch.exp(lg - m[..., None]).sum(dim=-1), mesh, vax))
        mine = (lab >= lo) & (lab < lo + V)
        idx = torch.clamp(lab.long() - lo, 0, V - 1)[..., None]
        ll = psum(torch.where(mine, torch.take_along_dim(lg, idx, dim=-1)[..., 0], 0.0),
                  mesh, vax)
        return lse, ll

    return local_call(core, (logits, labels), (names, names[:2]), (names[:2], names[:2]),
                      (labels.shape, labels.shape))
