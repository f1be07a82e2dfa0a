"""Mixture-of-Experts block: deterministic capacity-based top-k dispatch.

Counterpart of ``repro/models/moe.py``: GShard / Switch-style dense
dispatch as one-hot products, every expert over the ``cap`` slots of each
group, with shared experts behind a sigmoid gate (Qwen-MoE) or
fine-grained routed experts alone (DBRX).  Plain PyTorch, as the JAX
package's block is plain XLA: the dispatch, expert and combine products
are ``torch.einsum``.

The rules are the JAX package's, step for step:

* **Grouping.** The B·S tokens are taken, in order, as groups of
  ``g = min(GROUP, B·S)``.  Past ``GROUP`` tokens that needs B·S to be a
  multiple of ``GROUP``: the JAX function fails in its reshape there (e.g.
  at (3, 100) or (1, 300)), and the port raises a ``ValueError`` that
  names the rule at exactly those shapes.  It neither pads nor groups
  raggedly, which the reference does not do either.
* **Routing.** Router logits in the compute dtype, then float32; softmax,
  top-k, the k gate weights renormalised to sum to one.
* **Capacity.** Dropless (``cap = g``) when g <= 128; otherwise
  ``cap = max(4, round_up_4(ceil(g·k/E·CAPACITY_FACTOR)))``.  Slots go
  k-major: every token's first choice, then every second choice, and so
  on, in token order within each; an assignment past its expert's ``cap``
  is dropped.
* **Auxiliary loss.** The Switch load-balance term over the assignments
  before the capacity drop, plus a 1e-3 router z-loss.

Top-k ties: ``jax.lax.top_k`` puts the lower expert index first and
``torch.topk`` promises no order among equal values.  No tie-break is
added; tests that hold the port to the JAX package check that their
inputs keep the k-th and (k+1)-th router logits apart.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.api import local_call, on_mesh, shard
from .layers import dense_init, mlp, mlp_init

CAPACITY_FACTOR = 1.25
GROUP = 256


def moe_init(generator: torch.Generator, cfg):
    """The block's parameters, drawn on the generator's device, under the
    JAX names and scales: ``router`` (D, E) at 0.02, ``w_gate`` / ``w_up``
    (E, D, F) ~ N(0, 1/D), ``w_out`` (E, F, D) ~ N(0, 1/F); with shared
    experts, ``shared`` (an MLP of width ``n_shared_experts · F``) and
    ``shared_gate`` (D, 1) at 0.02."""
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dev = generator.device

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev).div_(math.sqrt(fan_in))

    p = {"router": dense_init(generator, D, E, scale=0.02),
         "w_gate": normal((E, D, F_), D),
         "w_up": normal((E, D, F_), D),
         "w_out": normal((E, F_, D), F_)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(generator, D, cfg.n_shared_experts * F_, cfg.act)
        p["shared_gate"] = dense_init(generator, D, 1, scale=0.02)
    return p


def capacity(g: int, k: int, E: int) -> int:
    """Slots an expert takes in a group of ``g`` tokens."""
    if g <= 128:
        return g   # dropless for decode and tiny groups
    cap = int(math.ceil(g * k / E * CAPACITY_FACTOR))
    return max(4, -(-cap // 4) * 4)


def group_size(tokens: int) -> int:
    """The group size for ``tokens`` = B·S tokens; raises where the JAX
    package's reshape into groups fails."""
    g = min(GROUP, tokens)
    if tokens % g:
        raise ValueError(
            f"moe_apply takes B·S = {tokens} tokens in groups of {GROUP}: past {GROUP} "
            f"tokens B·S must be a multiple of {GROUP} (the JAX reference fails its reshape "
            f"there; the port neither pads nor groups raggedly)")
    return g


class Routing(NamedTuple):
    """One call's routing, groups first: ``logits`` / ``probs`` (ng, g, E)
    float32, ``gate_w`` / ``idx`` (ng, g, k), ``onehot`` (ng, g, k, E) the
    assignments before the capacity drop, ``keep`` (ng, k·g, E) those kept,
    k-major, ``slot`` (ng, k·g, E) each one's slot, ``cap``."""
    logits: torch.Tensor
    probs: torch.Tensor
    gate_w: torch.Tensor
    idx: torch.Tensor
    onehot: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def route(p, xg: torch.Tensor, cfg) -> Routing:
    """The router over grouped tokens ``xg`` (ng, g, D)."""
    ng, g, _ = xg.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    logits = (xg @ p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, idx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    cap = capacity(g, k, E)
    onehot = (idx[..., None] == torch.arange(E, device=xg.device)).float()
    flat = onehot.transpose(1, 2).reshape(ng, k * g, E)          # k-major priority
    slot = torch.cumsum(flat, dim=1) - 1.0                        # slot within expert
    keep = flat * (slot < cap)
    return Routing(logits, probs, gate_w, idx, onehot, keep, slot, cap)


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y in x's dtype, aux float32 scalar).  On a mesh the
    routed experts run on each device's groups and expert shards
    (:func:`_moe_on_mesh`)."""
    dt = x.dtype
    B, S, D = x.shape
    E = cfg.n_experts
    g = group_size(B * S)
    ng = B * S // g
    if on_mesh(x):
        y, me, ce, zl = _moe_on_mesh(p, x, cfg, ng, g)
    else:
        y, me, ce, zl = _routed_experts(p, x.reshape(ng, g, D), cfg)
        y = y.reshape(B, S, D)

    if cfg.n_shared_experts:
        sg = torch.sigmoid(x @ p["shared_gate"].to(dt))
        y = y + sg * mlp(p["shared"], x, cfg.act)

    # load-balance auxiliary loss (Switch) + router z-loss
    aux = E * torch.sum(me * ce) + 1e-3 * zl
    return shard(y, "batch", "seq", None), aux


def _routed_experts(p, xg: torch.Tensor, cfg, experts: Optional[slice] = None):
    """Route, dispatch, run the experts and combine, over groups ``xg``
    (ng, g, D).  Returns (y (ng, g, D), the mean router probability an
    expert (E,), the fraction routed to each (E,), the mean squared router
    log-normaliser), the last three over ``xg``'s tokens.  ``experts``: the
    slice of the experts whose weights ``p`` holds (a device's expert
    shard); its y is that slice's share of the sum over experts."""
    dt = xg.dtype
    ng, g, D = xg.shape
    k = cfg.n_experts_per_tok
    r = route(p, xg, cfg)
    cap = r.cap

    # a slot one-hot by comparison: -1 and slots at or past cap give a zero row
    slots = torch.arange(cap, device=xg.device, dtype=torch.float32)
    disp_flat = (r.keep[..., None] * (r.slot[..., None] == slots)).reshape(ng, k, g, -1, cap)
    disp = disp_flat.sum(1)                                       # (ng, g, E, cap)
    comb = (disp_flat * r.gate_w.transpose(1, 2)[..., None, None]).sum(1)
    if experts is not None:
        disp, comb = disp[:, :, experts], comb[:, :, experts]

    x_e = torch.einsum("ngd,ngec->necd", xg, disp.to(dt))         # (ng, E, cap, D)
    gate = torch.einsum("necd,edf->necf", x_e, p["w_gate"].to(dt))
    up = torch.einsum("necd,edf->necf", x_e, p["w_up"].to(dt))
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    y_e = torch.einsum("necf,efd->necd", act * up, p["w_out"].to(dt))
    y = torch.einsum("necd,ngec->ngd", y_e, comb.to(dt))
    me = r.probs.mean(dim=(0, 1))                                 # mean prob / expert
    ce = r.onehot.sum(2).mean(dim=(0, 1))                         # fraction routed
    zl = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)))
    return y, me, ce, zl


def _moe_on_mesh(p, x, cfg, ng: int, g: int):
    """:func:`_routed_experts` as each device's program: its groups (those
    of its batch shard, or every group where they do not split over the
    batch axes, as JAX's ``shard(xg, "batch", None, None)`` demotes them)
    against its experts, or against every expert's shard of the hidden dim
    where the experts do not divide the model axis (the F dim's fallback
    in the MoE rules).  The routed output is a partial sum over the model
    axis.  The load statistics are each device's share (its groups' means
    over the number of devices that split the work), summed: every device
    of the model axis routes its groups alike, so the router's gradient
    sums each one's share of them once."""
    from torch.distributed.tensor import Partial, Replicate
    from ..parallel.api import layout
    B, S, D = x.shape
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    group_pl = layout(("batch", None, None), (ng, g, D), mesh)
    rows = ("batch", None, None) if all(
        not pl.is_shard() or B % mesh.size(i) == 0 for i, pl in enumerate(group_pl)) \
        and any(pl.is_shard() for pl in group_pl) else (None, None, None)
    x_pl = layout(rows, x.shape, mesh)
    w = p["w_gate"]
    e_split = [i for i, pl in enumerate(w.placements) if pl.is_shard(0)]
    tp = [i for i, pl in enumerate(w.placements) if pl.is_shard()]
    experts = None
    if e_split:
        n = cfg.n_experts // math.prod(mesh.size(i) for i in e_split)
        c = mesh.get_coordinate()
        lo = sum(c[i] for i in e_split) * n   # one expert axis in every rule
        experts = slice(lo, lo + n)

    split = [i for i, pl in enumerate(x_pl) if pl.is_shard() or i in tp]
    share = math.prod(mesh.size(i) for i in split)

    def core(xl, router, wg, wu, wo):
        y, me, ce, zl = _routed_experts(
            {"router": router, "w_gate": wg, "w_up": wu, "w_out": wo},
            xl.reshape(-1, g, D), cfg, experts)
        return y.reshape(xl.shape), me / share, ce / share, zl / share

    def out(base):
        return [Partial() if i in tp else pl for i, pl in enumerate(base)]

    stat = [Partial() if i in split else Replicate() for i in range(mesh.ndim)]
    return local_call(core, (x, p["router"], w, p["w_up"], p["w_out"]),
                      (rows, ..., ..., ..., ...),
                      (out(x_pl), stat, stat, stat), (x.shape, (cfg.n_experts,),
                                                      (cfg.n_experts,), ()))


def router_margin(logits: torch.Tensor, k: int) -> float:
    """The least gap between neighbours among each token's k+1 largest
    router logits, over the largest |logit|: how far the top-k choice and
    its order are from a tie."""
    top = torch.topk(logits.detach().float(), k + 1, dim=-1).values
    return float((top[..., :-1] - top[..., 1:]).min() / logits.detach().abs().max())
