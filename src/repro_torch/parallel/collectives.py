"""Differentiable collectives for results that every rank holds whole.

The sharded Gram's contract is the JAX package's: every rank passes the
same inputs and gets the whole result back, so every rank goes on to
compute the same loss from it.  Under that contract
``torch.distributed.nn.functional.all_gather`` is wrong: its backward sums
the cotangents of all ranks, which are equal, so each rank's gradient comes
out ``world_size`` times too large.  The two operations here split the
gradient the right way:

* :func:`gather` concatenates the ranks' shares; its backward hands each
  rank the slice of the (replicated) cotangent that its share became, with
  no reduction;
* :func:`sum_grads` is the identity on a replicated input that each rank
  uses for its own share only; its backward sums the ranks' gradients, so
  every rank holds the whole gradient again.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import spans


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        with spans.span(spans.COLLECTIVE):
            return g.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.n, ctx.n), None, None


class _SumGrads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with spans.span(spans.COLLECTIVE):
            g = g.clone(memory_format=torch.contiguous_format)
            for group in ctx.groups:
                dist.all_reduce(g, group=group)
            return g, None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate along ``dim`` the shares of every rank of ``group``, in
    group-rank order.  Every rank of the group must call it, each with a
    share of the same shape."""
    with spans.span(spans.COLLECTIVE):
        return _Gather.apply(x, group, dim)


def sum_grads(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over each group of ``groups`` in
    turn (the row and column groups of a mesh: the sum over all of it)."""
    return _SumGrads.apply(x, tuple(groups))
