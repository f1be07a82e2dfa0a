"""The comparison's control in the program's place: the port's entry points
computed by the reference in float32 with Δ's products in TF32
(:class:`.calls.Precision` with ``control=True``), differentiable through
the reference's adjoint.  A run with these in place of the port has to come
out not correct (``tests/faults.py:control``).

A Gram is solved in blocks of pairs, and its backward solves each block
again with its gradient, so that no more than one block's node grids live
at a time."""

from __future__ import annotations

import torch

from .calls import Precision, _block, _kernel


def _lam(grid) -> int:
    return 0 if grid is None else int(grid.lam1)


def _pairs(bx: int, by: int, device):
    a, b = torch.meshgrid(torch.arange(bx, device=device), torch.arange(by, device=device),
                          indexing="ij")
    return a.reshape(-1), b.reshape(-1)


class _Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dx, dy, lam):
        prec = Precision(control=True)
        a, b = _pairs(dx.shape[0], dy.shape[0], dx.device)
        step = _block(dx.shape[1], dy.shape[1], lam, prec.dtype)
        k = torch.cat([_kernel(dx[a[s:s + step]], dy[b[s:s + step]], lam, prec)
                       for s in range(0, a.numel(), step)])
        ctx.save_for_backward(dx, dy)
        ctx.lam, ctx.step = lam, step
        return k.reshape(dx.shape[0], dy.shape[0])

    @staticmethod
    def backward(ctx, gk):
        dx, dy = ctx.saved_tensors
        prec = Precision(control=True)
        a, b = _pairs(dx.shape[0], dy.shape[0], dx.device)
        gx, gy = torch.zeros_like(dx), torch.zeros_like(dy)
        gk = gk.reshape(-1)
        for s in range(0, a.numel(), ctx.step):
            ia, ib = a[s:s + ctx.step], b[s:s + ctx.step]
            with torch.enable_grad():
                xa = dx[ia].detach().requires_grad_()
                yb = dy[ib].detach().requires_grad_()
                k = _kernel(xa, yb, ctx.lam, prec)
                ga, gb = torch.autograd.grad(k, (xa, yb), gk[s:s + ctx.step])
            gx.index_add_(0, ia, ga)
            gy.index_add_(0, ib, gb)
        return gx, gy, None


def gram(X: torch.Tensor, Y=None, *, grid=None, **_) -> torch.Tensor:
    """K[a, b] = k(X_a, Y_b) (Y = X when omitted)."""
    prec = Precision(control=True)
    Y = X if Y is None else Y
    return _Gram.apply(prec.increments(X), prec.increments(Y), _lam(grid))


def mmd2(X: torch.Tensor, Y: torch.Tensor, *, grid=None, **_) -> torch.Tensor:
    """The unbiased MMD² from the three Grams."""
    bx, by = X.shape[0], Y.shape[0]
    Kxx, Kyy, Kxy = gram(X, grid=grid), gram(Y, grid=grid), gram(X, Y, grid=grid)
    return ((Kxx.sum() - torch.trace(Kxx)) / (bx * (bx - 1))
            + (Kyy.sum() - torch.trace(Kyy)) / (by * (by - 1)) - 2.0 * Kxy.mean())


def sigkernel(x: torch.Tensor, y: torch.Tensor, *, grid=None, **_) -> torch.Tensor:
    """k(x_p, y_p) for each pair p."""
    prec = Precision(control=True)
    return _kernel(prec.increments(x), prec.increments(y), _lam(grid), prec)
