"""The calls the cells time, computed again in plain PyTorch.

Each function takes the same raw inputs the program was given (float32
points on the device) and returns what the program's call returns: the
value, and the gradient with respect to the first batch where the cell
asks for one.  Pairs go through :mod:`.goursat` in blocks, so that the
node grids of one block fit on the card; each block's share of the loss
is differentiated on its own and the gradients add up.

Float64 is the reference.  ``control=True`` is the
comparison's control: the same computation in float32 with Δ's products
as a TF32 matmul forms them (both operands rounded to TF32's 10 mantissa
bits, sums in float32; its backward likewise), the precision one step
below the float32 with TF32 off that the configurations state.
"""

from __future__ import annotations

import torch

from . import goursat

#: bytes of node grids, Δ, adjoint and gradient a block of pairs may hold
BLOCK_BYTES = 6 << 30


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    """How a reference call computes: float64, or the float32/TF32 control."""

    def __init__(self, control: bool = False):
        self.control = control
        self.dtype = torch.float32 if control else torch.float64

    def increments(self, paths: torch.Tensor) -> torch.Tensor:
        return paths.to(self.dtype).diff(dim=-2)

    def delta(self, da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
        if self.control:
            return _DeltaTf32.apply(da, db)
        return torch.einsum("pid,pjd->pij", da, db)


class _DeltaTf32(torch.autograd.Function):
    """Δ = da·dbᵀ as a TF32 matmul computes it, forward and backward: both
    operands of each product rounded to TF32, sums in float32."""

    @staticmethod
    def forward(ctx, da, db):
        ra, rb = round_tf32(da), round_tf32(db)
        ctx.save_for_backward(ra, rb)
        return torch.einsum("pid,pjd->pij", ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return (torch.einsum("pij,pjd->pid", rg, rb),
                torch.einsum("pij,pid->pjd", rg, ra))


def _kernel(da: torch.Tensor, db: torch.Tensor, lam: int, prec: Precision) -> torch.Tensor:
    """k for pairs of increments (P, n, d) x (P, m, d) -> (P,), at dyadic
    order ``lam`` on both axes."""
    delta = prec.delta(da, db)
    if lam:
        delta = delta.repeat_interleave(1 << lam, dim=1).repeat_interleave(1 << lam, dim=2)
        delta = delta * 2.0 ** (-2 * lam)
    return goursat.solve(delta)


def _block(n: int, m: int, lam: int, dtype: torch.dtype) -> int:
    cells = ((n << lam) + 2) * ((m << lam) + 2)
    return max(1, BLOCK_BYTES // (5 * cells * torch.finfo(dtype).bits // 8))


def _pair_sum(da, db, a_idx, b_idx, lam, prec, weight, leaf=None):
    """Σ weight·k over the pairs (a_idx, b_idx), block by block; where
    ``leaf`` is given, its gradient accumulates block by block."""
    total = torch.zeros((), dtype=prec.dtype, device=da.device)
    step = _block(da.shape[1], db.shape[1], lam, prec.dtype)
    for s in range(0, a_idx.numel(), step):
        a, b = a_idx[s:s + step], b_idx[s:s + step]
        if leaf is None:
            with torch.no_grad():
                total += weight * _kernel(da[a], db[b], lam, prec).sum()
            continue
        part = weight * _kernel(da[a], db[b], lam, prec).sum()
        part.backward(retain_graph=True)
        total += part.detach()
    return total


def mmd2(X: torch.Tensor, Y: torch.Tensor, *, lam: int = 0, grad: bool = False,
         control: bool = False):
    """The unbiased MMD² between the batches X and Y, and its gradient with
    respect to X (None unless ``grad``)."""
    prec = Precision(control)
    dev = X.device
    bx, by = X.shape[0], Y.shape[0]
    leaf = X.detach().to(prec.dtype).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        dx = prec.increments(leaf)
    with torch.no_grad():
        dy = prec.increments(Y)
    ax, bx_idx = torch.triu_indices(bx, bx, 1, device=dev)
    ay, by_idx = torch.triu_indices(by, by, 1, device=dev)
    cx, cy = torch.meshgrid(torch.arange(bx, device=dev), torch.arange(by, device=dev),
                            indexing="ij")
    lx = leaf if grad else None
    value = (_pair_sum(dx, dx, ax, bx_idx, lam, prec, 2.0 / (bx * (bx - 1)), lx)
             + _pair_sum(dy, dy, ay, by_idx, lam, prec, 2.0 / (by * (by - 1)))
             + _pair_sum(dx, dy, cx.reshape(-1), cy.reshape(-1), lam, prec,
                         -2.0 / (bx * by), lx))
    return value, (leaf.grad if grad else None)


def sigkernel(x: torch.Tensor, y: torch.Tensor, *, lam: int = 0, grad: bool = False,
              control: bool = False):
    """k(x_p, y_p) for each pair p, and the gradient of their sum with
    respect to x (None unless ``grad``)."""
    prec = Precision(control)
    leaf = x.detach().to(prec.dtype).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        dx = prec.increments(leaf)
    with torch.no_grad():
        dy = prec.increments(y)
    step = _block(dx.shape[1], dy.shape[1], lam, prec.dtype)
    values = []
    for s in range(0, x.shape[0], step):
        with torch.set_grad_enabled(grad):
            k = _kernel(dx[s:s + step], dy[s:s + step], lam, prec)
        if grad:
            k.sum().backward(retain_graph=True)
        values.append(k.detach())
    return torch.cat(values), (leaf.grad if grad else None)
