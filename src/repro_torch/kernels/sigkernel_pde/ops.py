"""Wrappers for the Goursat-PDE kernels, forward and backward.

Counterpart of ``repro/kernels/sigkernel_pde/ops.py``.  Responsibilities:

* dtype discipline: the kernels compute in float32 (bf16/f16 inputs are
  upcast, float64 is cast down as the JAX wrappers do); the CPU path keeps
  at least float32, so float64 stays float64 there;
* batch flattening;
* the strip height T for this card (:func:`choose_T`);
* device routing: a CUDA tensor launches the kernel (or raises), a CPU
  tensor takes the kernel's plain version.  There is no fallback between
  the two;
* gradients: ``solve``, ``solve_fused`` and ``gram_fused`` are
  ``torch.autograd.Function`` classes whose backward is the JAX package's
  (``ops.py:165-241``): Δ is rebuilt where the forward never held it, the
  forward reruns in its checkpoint mode (``solve_with_grid``), the
  backward kernel gives ∂F/∂Δ (``solve_grad``), and ``einsum`` pulls it
  back onto the increments.  The strip height T is chosen once per
  forward and kept for its backward, so the backward's strips line up with
  the checkpoint rows.  Without an input that requires grad, the forward
  takes the plain forward kernel and saves nothing.

The zero padding of Lx to the strip (JAX ``ops.py:49-54``, ``:147-149``,
``:201-203``) happens inside the kernels by index arithmetic: rows at or
past Lx read Δ = 0, which is what a zero-padded copy would hold, without
copying Δ.
"""

from __future__ import annotations

import torch

from . import kernel, stencil

#: Strip caps from chip_smoke.py's strip sweep on an H100: a launch with
#: few problems (one block per SM) is latency-bound, and tall strips cut its
#: dependent steps (at 1023 x 1023, 512 and 1024 were within run-to-run
#: noise of each other and well ahead of 256); one with more than
#: _MANY_PROBLEMS blocks fills the card several times over, and short
#: strips keep the wavefront's lanes busy (64 beat 128 by ~12% at 128 x 128
#: pairs of 255 x 255, and tied with 32).  The fused kernels, whose blocks
#: add producer warps to the wavefront, take 128 there: at every many-problem
#: launch of the main paths (2,048 to 16,384 pairs of 255 x 255, d = 8) 128
#: beat 64 by 14-16% and 256 by 45-50% (chip_smoke strip sweep, H100 SXM).
_FEW_PROBLEMS_T = 512
_MANY_PROBLEMS = 4 * 132
_MANY_PROBLEMS_T = 64
_MANY_PROBLEMS_FUSED_T = 128


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def choose_T(Lx: int, Ly: int, lam1: int, lam2: int, n_problems: int, *,
             d: int = 0, scheme: str = "order1", max_t=None,
             backward: bool = False) -> int:
    """Strip height (threads per block) for one launch on an H100.

    The largest power of two that is at most ``max_t`` (a
    ``LaunchConfig.pde_strip`` cap; default 512 threads, or 64 when the
    launch has more than ``_MANY_PROBLEMS`` blocks, 128 for the fused
    kernels), at most the refined
    row count rounded up, at least ``max(2, 2**lam1)``, and whose shared
    memory fits one block (fused launches, ``d > 0``: at most
    ``kernel.FUSED_MAX_THREADS``).  ``backward=True`` picks the one T that
    both the checkpoint forward and the backward kernel take (at most
    ``kernel.BWD_MAX_THREADS``, and the backward's shared memory fits too).
    Raises ValueError when even the smallest strip does not fit.
    """
    fused = d > 0
    t_min = max(2, 1 << lam1)
    max_threads = (kernel.BWD_MAX_THREADS if backward else
                   kernel.FUSED_MAX_THREADS if fused else kernel.MAX_THREADS)
    many_t = _MANY_PROBLEMS_FUSED_T if fused else _MANY_PROBLEMS_T
    cap = max_t or (many_t if n_problems > _MANY_PROBLEMS else _FEW_PROBLEMS_T)

    def need(T):
        n = kernel.smem_bytes(fused, scheme, T, Ly, lam1, lam2, d)
        if backward:
            n = max(n, kernel.smem_bytes_bwd(scheme, T, Ly, lam1, lam2))
        return n

    T = max(t_min, min(cap, max_threads, _pow2_ceil(Lx << lam1)))
    while T > t_min and need(T) > kernel.SMEM_LIMIT:
        T //= 2
    if need(T) > kernel.SMEM_LIMIT or T > max_threads:
        raise ValueError(
            f"no Goursat strip fits one H100 block: T={T} needs {need(T)} bytes "
            f"of shared memory (limit {kernel.SMEM_LIMIT}) and at most "
            f"{max_threads} threads (ny={Ly << lam2}, lam1={lam1}, "
            f"scheme={scheme!r}) — lower lam1/lam2 or shorten the paths")
    return T


def _max_t(launch):
    return getattr(launch, "pde_strip", None)


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}: use 'cuda' or 'cpu'")
    return t.device.type


def _working(t: torch.Tensor, device: str) -> torch.Tensor:
    if device == "cuda":
        return t.to(torch.float32).contiguous()
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _flat(delta: torch.Tensor, device: str) -> torch.Tensor:
    return _working(delta.reshape((-1,) + tuple(delta.shape[-2:])), device)


def solve(delta: torch.Tensor, lam1: int = 0, lam2: int = 0, launch=None,
          scheme: str = "order1", interior_dtype: str = "float32") -> torch.Tensor:
    """Final kernel values for Δ (..., Lx, Ly) -> (...,), differentiable in
    Δ."""
    device = _route(delta)
    if _needs_grad(delta):
        return _Solve.apply(delta, lam1, lam2, launch, scheme, interior_dtype)
    flat = _flat(delta, device)
    if device == "cpu":
        k = kernel.solve_plain(flat, lam1, lam2, scheme, interior_dtype)
    else:
        B, Lx, Ly = flat.shape
        T = choose_T(Lx, Ly, lam1, lam2, B, scheme=scheme, max_t=_max_t(launch))
        k = kernel.fwd(flat, T, lam1, lam2, scheme, interior_dtype)
    return k.reshape(delta.shape[:-2])


def solve_with_grid(delta: torch.Tensor, lam1: int = 0, lam2: int = 0, launch=None,
                    scheme: str = "order1", interior_dtype: str = "float32"):
    """Forward and the residuals of the exact backward (checkpoint rows,
    not the full grid).  Returns ``(k, cps, T)``; pass T on to
    :func:`solve_grad`."""
    device = _route(delta)
    flat = _flat(delta, device)
    B, Lx, Ly = flat.shape
    T = choose_T(Lx, Ly, lam1, lam2, B, scheme=scheme, max_t=_max_t(launch),
                 backward=True)
    if device == "cpu":
        k, cps = kernel.solve_with_grid_plain(flat, T, lam1, lam2, scheme, interior_dtype)
    else:
        k, cps = kernel.fwd_cps(flat, T, lam1, lam2, scheme, interior_dtype)
    return k.reshape(delta.shape[:-2]), cps, T


def solve_grad(delta: torch.Tensor, cps: torch.Tensor, gbar: torch.Tensor, T: int,
               lam1: int = 0, lam2: int = 0, scheme: str = "order1",
               interior_dtype: str = "float32") -> torch.Tensor:
    """Exact ∂F/∂Δ (paper Alg 4) from the checkpoint rows that
    :func:`solve_with_grid` saved at strip height ``T`` (the scheme and the
    interior dtype must be the forward's too: the backward recomputes the
    strip interiors with the same stencil and rounding)."""
    device = _route(delta)
    flat = _flat(delta, device)
    g = _working(gbar.reshape(-1), device)
    if device == "cpu":
        dd = kernel.solve_grad_plain(flat, cps.to(flat.dtype), g.to(flat.dtype), T,
                                     lam1, lam2, scheme, interior_dtype)
    else:
        dd = kernel.bwd(flat, cps, g, T, lam1, lam2, scheme, interior_dtype)
    return dd.reshape(delta.shape).to(delta.dtype)


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, lam1, lam2, launch, scheme, interior_dtype):
        k, cps, T = solve_with_grid(delta, lam1, lam2, launch, scheme, interior_dtype)
        ctx.save_for_backward(delta, cps)
        ctx.args = (T, lam1, lam2, scheme, interior_dtype)
        return k

    @staticmethod
    def backward(ctx, gbar):
        delta, cps = ctx.saved_tensors
        return (solve_grad(delta, cps, gbar, *ctx.args), None, None, None, None, None)


def _rebuilt_grad(delta: torch.Tensor, gbar: torch.Tensor, lam1, lam2, launch, scheme,
                  interior_dtype) -> torch.Tensor:
    """∂F/∂Δ for a Δ the forward never held: checkpoint forward, then the
    backward, at one shared strip height."""
    _, cps, T = solve_with_grid(delta, lam1, lam2, launch, scheme, interior_dtype)
    return solve_grad(delta, cps, gbar, T, lam1, lam2, scheme, interior_dtype)


class _SolveFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dx, dy, lam1, lam2, launch, scheme, interior_dtype):
        ctx.save_for_backward(dx, dy)
        ctx.args = (lam1, lam2, launch, scheme, interior_dtype)
        return _solve_fused_forward(dx, dy, *ctx.args)

    @staticmethod
    def backward(ctx, gbar):
        dx, dy = ctx.saved_tensors
        xw, yw = _working(dx, dx.device.type), _working(dy, dy.device.type)
        dd = _rebuilt_grad(stencil.delta_einsum("bid,bjd->bij", xw, yw), gbar, *ctx.args)
        ddx = torch.einsum("bij,bjd->bid", dd, yw)
        ddy = torch.einsum("bij,bid->bjd", dd, xw)
        return ddx.to(dx.dtype), ddy.to(dy.dtype), None, None, None, None, None


class _GramFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dX, dY, lam1, lam2, launch, scheme, interior_dtype):
        ctx.save_for_backward(dX, dY)
        ctx.args = (lam1, lam2, launch, scheme, interior_dtype)
        return _gram_fused_forward(dX, dY, *ctx.args)

    @staticmethod
    def backward(ctx, gbar):
        # the reverse sweep holds the Bx·By pairwise Δ: row-block the Gram
        # (core/gram.py) to bound it
        dX, dY = ctx.saved_tensors
        xw, yw = _working(dX, dX.device.type), _working(dY, dY.device.type)
        dd = _rebuilt_grad(stencil.delta_einsum("aid,bjd->abij", xw, yw), gbar,
                           *ctx.args)
        ddX = torch.einsum("abij,bjd->aid", dd, yw)
        ddY = torch.einsum("abij,aid->bjd", dd, xw)
        return ddX.to(dX.dtype), ddY.to(dY.dtype), None, None, None, None, None


def _solve_fused_forward(dx, dy, lam1, lam2, launch, scheme, interior_dtype):
    device = _route(dx)
    dx, dy = _working(dx, device), _working(dy, device)
    if device == "cpu":
        return kernel.solve_fused_plain(dx, dy, lam1, lam2, scheme, interior_dtype)
    B, Lx, d = dx.shape
    T = choose_T(Lx, dy.shape[1], lam1, lam2, B, d=d, scheme=scheme,
                 max_t=_max_t(launch))
    return kernel.fwd_fused(dx, dy, T, lam1, lam2, scheme, interior_dtype)


def _gram_fused_forward(dX, dY, lam1, lam2, launch, scheme, interior_dtype):
    device = _route(dX)
    dX, dY = _working(dX, device), _working(dY, device)
    if device == "cpu":
        return kernel.gram_fused_plain(dX, dY, lam1, lam2, scheme, interior_dtype)
    Bx, Lx, d = dX.shape
    T = choose_T(Lx, dY.shape[1], lam1, lam2, Bx * dY.shape[0], d=d,
                 scheme=scheme, max_t=_max_t(launch))
    return kernel.gram_fused(dX, dY, T, lam1, lam2, scheme, interior_dtype)


def solve_fused(dx: torch.Tensor, dy: torch.Tensor, lam1: int = 0, lam2: int = 0,
                launch=None, scheme: str = "order1",
                interior_dtype: str = "float32") -> torch.Tensor:
    """k̂ final values from increments directly. dx: (B, Lx, d), dy: (B, Ly, d).
    Differentiable in both."""
    args = (lam1, lam2, launch, scheme, interior_dtype)
    if _needs_grad(dx, dy):
        return _SolveFused.apply(dx, dy, *args)
    return _solve_fused_forward(dx, dy, *args)


def gram_fused(dX: torch.Tensor, dY: torch.Tensor, lam1: int = 0, lam2: int = 0,
               launch=None, scheme: str = "order1",
               interior_dtype: str = "float32") -> torch.Tensor:
    """Full Gram from increments. dX: (Bx, Lx, d), dY: (By, Ly, d) -> (Bx, By).
    Differentiable in both."""
    args = (lam1, lam2, launch, scheme, interior_dtype)
    if _needs_grad(dX, dY):
        return _GramFused.apply(dX, dY, *args)
    return _gram_fused_forward(dX, dY, *args)
