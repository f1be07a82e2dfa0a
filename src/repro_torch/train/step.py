"""Train-step factory: mixed precision and microbatch gradient
accumulation.

Counterpart of ``repro/train/step.py``.  The model's master parameters stay
in their dtype (float32 by default, :func:`apply_param_dtype`); each step
casts a compute copy once (:func:`cast_compute`), takes the gradients at
that copy, casts them to float32 and, over ``num_microbatches``, sums them
in ``accum_dtype`` and averages.  The optimizer then updates the master
copy.  Its ``param_pspecs`` is the JAX factory's: on a mesh (parameters
that are DTensors), each gradient and its accumulator take their
parameter's layout, so FSDP's gradients reduce-scatter into shards.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

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
    """The batch split along its leading axis into n equal parts of
    contiguous rows; scalars and non-tensors go to every part.  A DTensor's
    rows are gathered once over the devices that split them and each part
    laid out again as the batch was (the JAX reshape, which XLA lays out
    alike)."""
    from torch.distributed.tensor import DTensor, Replicate

    def rows(v):
        if isinstance(v, DTensor) and v.ndim:
            return v.redistribute(v.device_mesh, [Replicate() if p.is_shard(0) else p
                                                  for p in v.placements])
        return v

    def part(v, w, i):
        if not (torch.is_tensor(v) and v.ndim):
            return v
        w = w.reshape(n, w.shape[0] // n, *w.shape[1:])[i]
        return w.redistribute(v.device_mesh, v.placements) if isinstance(v, DTensor) else w

    whole = {k: rows(v) for k, v in batch.items()}
    return [{k: part(v, whole[k], i) for k, v in batch.items()} for i in range(n)]


def make_train_step(model, optimizer, *, num_microbatches: int = 1,
                    param_pspecs: Optional[Dict] = None,
                    accum_dtype: str = "float32") -> Callable[[Dict], Dict]:
    """``train_step(batch) -> metrics``: one optimizer step of ``model``
    (a module with ``cfg`` and ``loss(batch, params=)``, whose parameters
    ``optimizer`` holds) on ``batch``.  ``accum_dtype``: the gradient
    accumulator's dtype (bf16 halves its memory).  The gradients reach the
    optimizer as the parameters' ``.grad``, in the parameters' dtype.
    ``param_pspecs``: a tree of specs over the parameters
    (:func:`repro_torch.parallel.sharding.param_shardings`); each DTensor
    gradient and accumulator is laid out by its parameter's spec.  With
    none, the step runs as on one device.
    Returns the model's metrics (averaged over the microbatches) with
    ``loss`` and the optimizer's ``grad_norm``."""
    cdt = getattr(torch, model.cfg.compute_dtype)
    adt = getattr(torch, accum_dtype)
    n = num_microbatches
    specs = None if param_pspecs is None else [s for _, s in tree_items(param_pspecs)]

    def constrain(tree):
        if specs is None:
            return tree
        from torch.distributed.tensor import DTensor

        from ..parallel.sharding import placements
        return [t.redistribute(t.device_mesh, placements(s, t.device_mesh))
                if isinstance(t, DTensor) else t for t, s in zip(tree, specs)]

    def value_and_grad(compute, leaves, mb):
        loss, metrics = model.loss(mb, params=compute)
        loss = loss.float()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, constrain(grads)

    def train_step(batch: Dict) -> Dict:
        with torch.no_grad():
            compute = cast_compute(model.tree(), cdt)
        compute = tree_map(lambda t: t.detach().requires_grad_(), compute)
        leaves = [t for _, t in tree_items(compute)]
        if n > 1:
            acc = ([torch.zeros(t.shape, dtype=adt, device=t.device) for t in leaves]
                   if specs is None else constrain([torch.zeros_like(t, dtype=adt)
                                                    for t in leaves]))
            loss_sum, per_mb = None, []
            for mb in _microbatches(batch, n):
                loss, metrics, grads = value_and_grad(compute, leaves, mb)
                acc = [a + g.to(adt) for a, g in zip(acc, grads)]
                # the first loss itself (0.0 + loss is loss): on a mesh, the sum of
                # partial losses then stays partial in every step alike
                loss_sum = loss if loss_sum is None else loss_sum + loss
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
