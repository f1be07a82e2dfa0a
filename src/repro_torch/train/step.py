"""Train-step factory: mixed precision and microbatch gradient
accumulation.

Counterpart of ``repro/train/step.py``.  The model's master parameters stay
in their dtype (float32 by default, :func:`apply_param_dtype`); each step
casts a compute copy once (:func:`cast_compute`), takes the gradients at
that copy, casts them to float32 and, over ``num_microbatches``, sums them
in ``accum_dtype`` and averages.  The optimizer then updates the master
copy.  The JAX factory's ``param_pspecs`` (sharding constraints on the
gradients) has no single-device counterpart and is left out.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.params import tree_items, tree_map


def cast_compute(params: Dict, dtype) -> Dict:
    """Floating leaves with ``ndim >= 1`` cast to ``dtype``; others as they are."""
    def one(p):
        if p.is_floating_point() and p.ndim >= 1:
            return p.to(dtype)
        return p
    return tree_map(one, params)


def apply_param_dtype(tree: Dict, cfg) -> Dict:
    """Master-parameter dtype policy (``cfg.param_dtype``; bf16 for
    340B-class models): floating leaves cast to it."""
    target = getattr(torch, cfg.param_dtype)
    return tree_map(lambda p: p.to(target) if p.is_floating_point() else p, tree)


def _microbatches(batch: Dict, n: int):
    """The batch split along its leading axis into n equal parts; scalars
    and non-tensors go to every part."""
    def part(v, i):
        if torch.is_tensor(v) and v.ndim:
            return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
        return v
    return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(model, optimizer, *, num_microbatches: int = 1,
                    accum_dtype: str = "float32") -> Callable[[Dict], Dict]:
    """``train_step(batch) -> metrics``: one optimizer step of ``model``
    (a module with ``cfg`` and ``loss(batch, params=)``, whose parameters
    ``optimizer`` holds) on ``batch``.  ``accum_dtype``: the gradient
    accumulator's dtype (bf16 halves its memory).  The gradients reach the
    optimizer as the parameters' ``.grad``, in the parameters' dtype.
    Returns the model's metrics (averaged over the microbatches) with
    ``loss`` and the optimizer's ``grad_norm``."""
    cdt = getattr(torch, model.cfg.compute_dtype)
    adt = getattr(torch, accum_dtype)
    n = num_microbatches

    def value_and_grad(compute, leaves, mb):
        loss, metrics = model.loss(mb, params=compute)
        loss = loss.float()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(batch: Dict) -> Dict:
        with torch.no_grad():
            compute = cast_compute(model.tree(), cdt)
        compute = tree_map(lambda t: t.detach().requires_grad_(), compute)
        leaves = [t for _, t in tree_items(compute)]
        if n > 1:
            acc = [torch.zeros(t.shape, dtype=adt, device=t.device) for t in leaves]
            loss_sum, per_mb = 0.0, []
            for mb in _microbatches(batch, n):
                loss, metrics, grads = value_and_grad(compute, leaves, mb)
                acc = [a + g.to(adt) for a, g in zip(acc, grads)]
                loss_sum = loss_sum + loss
                per_mb.append(metrics)
            grads = [a.div_(n) for a in acc]
            loss = loss_sum / n
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        else:
            loss, metrics, grads = value_and_grad(compute, leaves, batch)
        # the optimizer step holds neither the compute copy nor a second
        # copy of the gradients (at a 70B-class width, 6 bytes a parameter)
        del compute, leaves
        for (_, p), g in zip(tree_items(model.tree()), grads):
            p.grad = g.to(p.dtype)
        del grads
        return dict(metrics, loss=loss, **optimizer.step())

    return train_step


def make_eval_step(model) -> Callable[[Dict], Dict]:
    """``eval_step(batch) -> metrics`` (with ``loss``) at the compute dtype,
    without gradients."""
    cdt = getattr(torch, model.cfg.compute_dtype)

    @torch.no_grad()
    def eval_step(batch: Dict) -> Dict:
        loss, metrics = model.loss(batch, params=cast_compute(model.tree(), cdt))
        return dict(metrics, loss=loss)

    return eval_step
