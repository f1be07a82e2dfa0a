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
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

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
    """x: (B, S, D) -> (y in x's dtype, aux float32 scalar)."""
    dt = x.dtype
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    g = group_size(B * S)
    ng = B * S // g
    xg = x.reshape(ng, g, D)
    r = route(p, xg, cfg)
    cap = r.cap

    # a slot one-hot by comparison: -1 and slots at or past cap give a zero row
    slots = torch.arange(cap, device=x.device, dtype=torch.float32)
    disp_flat = (r.keep[..., None] * (r.slot[..., None] == slots)).reshape(ng, k, g, E, cap)
    disp = disp_flat.sum(1)                                       # (ng, g, E, cap)
    comb = (disp_flat * r.gate_w.transpose(1, 2)[..., None, None]).sum(1)

    x_e = torch.einsum("ngd,ngec->necd", xg, disp.to(dt))         # (ng, E, cap, D)
    gate = torch.einsum("necd,edf->necf", x_e, p["w_gate"].to(dt))
    up = torch.einsum("necd,edf->necf", x_e, p["w_up"].to(dt))
    act = F.silu(gate) if cfg.act == "silu" else F.gelu(gate, approximate="tanh")
    y_e = torch.einsum("necf,efd->necd", act * up, p["w_out"].to(dt))
    y = torch.einsum("necd,ngec->ngd", y_e, comb.to(dt)).reshape(B, S, D)

    if cfg.n_shared_experts:
        sg = torch.sigmoid(x @ p["shared_gate"].to(dt))
        y = y + sg * mlp(p["shared"], x, cfg.act)

    # load-balance auxiliary loss (Switch) + router z-loss
    me = r.probs.mean(dim=(0, 1))                                 # mean prob / expert
    ce = r.onehot.sum(2).mean(dim=(0, 1))                         # fraction routed
    aux = E * torch.sum(me * ce) + 1e-3 * torch.mean(
        torch.square(torch.logsumexp(r.logits, dim=-1)))
    return y, aux


def router_margin(logits: torch.Tensor, k: int) -> float:
    """The least gap between neighbours among each token's k+1 largest
    router logits, over the largest |logit|: how far the top-k choice and
    its order are from a tie."""
    top = torch.topk(logits.detach().float(), k + 1, dim=-1).values
    return float((top[..., :-1] - top[..., 1:]).min() / logits.detach().abs().max())
