"""AdamW with a global-norm clip, a configurable moment dtype and a cosine
schedule.

Counterpart of ``repro/optim/adamw.py``, written as a
``torch.optim.Optimizer``.  It keeps the JAX optimizer's semantics, which
``torch.optim.AdamW`` does not share: every gradient is scaled by
``min(1, clip_norm / ‖g‖)`` over all parameters before any update; the step
count starts at 1 and the schedule is called with it; the bias corrections
divide the moments; weight decay is added to the step before the ``lr``
multiply, and only on parameters with ``ndim >= 2`` (none on norms and
scalars); the moments are stored in ``moment_dtype`` (bf16 for the largest
models) and the update is computed in float32.  A parameter without a
gradient is updated as with a zero gradient, as the JAX tree update does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..models.params import tree_items, tree_map


class AdamW(torch.optim.Optimizer):
    """``lr``: a schedule, step count (from 1) -> learning rate."""

    def __init__(self, params, lr: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0, moment_dtype: str = "float32"):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.clip_norm = clip_norm
        self.moment_dtype = getattr(torch, moment_dtype)
        self.state["count"] = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update of every parameter.  Returns ``{"grad_norm": ‖g‖}``
        (before the clip)."""
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        # global-norm clip (float32 accumulate)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
        count = self.state["count"] = self.state["count"] + 1
        grad_of = {id(p): g for p, g in zip(params, grads)}
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            lr = group["lr"](count)
            b1c, b2c = 1.0 - b1 ** count, 1.0 - b2 ** count
            for p in group["params"]:
                state = self.state[p]
                if not state:   # laid out as the parameter (a DTensor's shards)
                    state["m"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    state["v"] = torch.zeros_like(p, dtype=self.moment_dtype)
                # the float32 update's operations in the order of
                # b1·m + (1 - b1)·g, b2·v + (1 - b2)·g·g,
                # (m / b1c) / (sqrt(v / b2c) + eps) + wd·p and p - lr·upd,
                # each temporary updated in place: at most four float32
                # copies of the leaf at once
                g = grad_of[id(p)].float() * scale
                m_new = state["m"].float().mul_(b1).add_((1 - b1) * g)
                v_new = state["v"].float().mul_(b2).add_(((1 - b2) * g).mul_(g))
                del g
                upd = (m_new / b1c).div_((v_new / b2c).sqrt_().add_(eps))
                if p.ndim >= 2:  # no decay on norms / scalars
                    upd.add_(wd * p.float())
                p.copy_(p.float().sub_(upd.mul_(lr)))
                state["m"].copy_(m_new)
                state["v"].copy_(v_new)
        return {"grad_norm": gnorm}

    def state_tree(self, params: Dict) -> Dict:
        """The optimizer state as the JAX ``AdamWState``'s tree, over
        ``params`` (a nested dict of this optimizer's parameters, e.g.
        ``model.tree()``): ``{"count": int32 scalar, "m": tree, "v": tree}``.
        The moments are the live tensors; a parameter not stepped yet gets
        zeros in ``moment_dtype``, as ``AdamW.init`` gives."""
        def moment(key):
            def one(p):
                state = self.state[p]
                return state[key] if state else torch.zeros(
                    p.shape, dtype=self.moment_dtype, device=p.device)
            return tree_map(one, params)
        return {"count": torch.tensor(self.state["count"], dtype=torch.int32),
                "m": moment("m"), "v": moment("v")}

    @torch.no_grad()
    def load_state_tree(self, params: Dict, state: Dict) -> None:
        """Set the state from a tree as :meth:`state_tree` gives (a JAX
        ``AdamWState`` carried across as one): the step count, on which the
        schedule depends, and each parameter's moments, copied to its
        device in ``moment_dtype``."""
        ms, vs = dict(tree_items(state["m"])), dict(tree_items(state["v"]))
        if set(ms) != set(vs) or set(ms) != {name for name, _ in tree_items(params)}:
            raise ValueError("the moment trees do not name the parameters")
        for name, p in tree_items(params):
            m, v = ms[name], vs[name]
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"moments of {name}: {tuple(m.shape)} and "
                                 f"{tuple(v.shape)} for a parameter of {tuple(p.shape)}")
            self.state[p] = {k: t.to(p.device, self.moment_dtype, copy=True)
                             for k, t in (("m", m), ("v", v))}
        self.state["count"] = int(state["count"])


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor · peak`` at ``total``."""
    def lr(step: int) -> float:
        if step < warmup:
            return peak * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
    return lr
