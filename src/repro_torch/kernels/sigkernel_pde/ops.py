"""Wrappers for the Goursat-PDE kernels, forward and backward.

Counterpart of ``repro/kernels/sigkernel_pde/ops.py``.  Responsibilities:

* dtype discipline: the kernels compute in float32 (bf16/f16 inputs are
  upcast, float64 is cast down as the JAX wrappers do); the CPU path keeps
  at least float32, so float64 stays float64 there;
* batch flattening;
* the launch geometry of the precomputed-Δ forward (:func:`geometry`) and
  the strip height T of the fused kernels and of the checkpoint rows the
  backward reads (:func:`choose_T`);
* device routing: a CUDA tensor launches the kernel (or raises), a CPU
  tensor takes the kernel's plain version.  There is no fallback between
  the two.  Each leaf solve is one ``torch.library`` op (``repro_torch::``
  ``goursat_fwd``, ``goursat_fwd_cps``, ``goursat_bwd``,
  ``goursat_fwd_fused``, ``goursat_gram_fused``) whose CUDA implementation
  is the kernel's launcher, whose CPU implementation is the plain version,
  and whose fake implementation gives the output shapes alone: a trace
  under ``FakeTensorMode`` (the streaming guard of ``core/gram.py``, the
  dry run) sees one op a solve and launches nothing;
* gradients: ``solve``, ``solve_fused`` and ``gram_fused`` are
  ``torch.autograd.Function`` classes whose backward is the JAX package's
  (``ops.py:165-241``): Δ is rebuilt where the forward never held it, the
  forward reruns in its checkpoint mode (``solve_with_grid``), the
  backward kernel gives ∂F/∂Δ (``solve_grad``), and ``einsum`` pulls it
  back onto the increments.  The checkpoint rows' strip height T is chosen
  once per forward and kept for its backward, so the backward's strips line
  up with them.  Without an input that requires grad, the forward takes the
  plain forward kernel and saves nothing.

The zero padding of Lx to the strip (JAX ``ops.py:49-54``, ``:147-149``,
``:201-203``) happens inside the kernels by index arithmetic: rows at or
past Lx read Δ = 0, which is what a zero-padded copy would hold, without
copying Δ.
"""

from __future__ import annotations

import torch

from . import kernel, stencil
from .._ops import define
from repro_torch import spans

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
#: The checkpoint rows keep these strips: the backward kernel sweeps them.
_FEW_PROBLEMS_T = 512
_MANY_PROBLEMS = 4 * 132
_MANY_PROBLEMS_T = 64
_MANY_PROBLEMS_FUSED_T = 128

#: The precomputed-Δ forward's rows a lane (kernel_bench ablate-fwd on an
#: H100, every launch shape of the main paths, both modes): R = 2 led at all
#: of them, from 64 to 16,384 pairs of 255 x 255 and at 128 x (1023, 1023);
#: R = 1 leaves a lane one cell a step and R >= 4 adds 32 idle lane-steps a
#: row to each band's skew and more copies to each warp's chunk.
_ROWS = 2


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def geometry(Lx: int, Ly: int, lam1: int = 0, lam2: int = 0, *, scheme: str = "order1",
             max_t=None, T=None) -> kernel.FwdGeometry:
    """Launch geometry of the precomputed-Δ forward on an H100, one problem
    a block.

    R (rows a lane): ``_ROWS``, at most the refined rows rounded up over
    32.  Warps a problem: one a band of 32·R rows, within the block's
    thread limit (``kernel.MAX_THREADS``) and shared memory; fewer warps
    loop over the bands.  ``max_t`` (a ``LaunchConfig.pde_strip`` cap)
    caps the rows a problem's warps cover at once at max(32, max_t); the
    checkpoint mode's strip height T caps R (a lane holds at most one
    checkpoint row).  The chunk of steps (staging, hand-over) is the CUDA
    source's constant, ``kernel.CHUNK``.  Raises ValueError when no geometry
    fits one block.
    """
    nx = Lx << lam1
    cap = max(32, max_t) if max_t else None
    R = _ROWS
    while R > 1 and (32 * R > _pow2_ceil(nx) or (cap and 32 * R > cap) or (T and R > T)):
        R //= 2
    warps = min(kernel.fwd_bands(nx, R), kernel.MAX_THREADS // 32)
    if cap:
        warps = min(warps, max(1, cap // (32 * R)))

    def smem(w):
        return kernel.fwd_smem_bytes(scheme, kernel.FwdGeometry(R, w), Lx, Ly, lam1, lam2)

    while warps > 1 and smem(warps) > kernel.SMEM_LIMIT:
        warps -= 1
    if smem(warps) > kernel.SMEM_LIMIT:
        raise ValueError(
            f"no forward geometry fits one H100 block: {(R, warps)} needs {smem(warps)} "
            f"bytes of shared memory (limit {kernel.SMEM_LIMIT}; nx={nx}, "
            f"ny={Ly << lam2}, scheme={scheme!r}) — lower lam1/lam2 or shorten the paths")
    return kernel.FwdGeometry(R, warps)


def choose_T(Lx: int, Ly: int, lam1: int, lam2: int, n_problems: int, *,
             d: int = 0, scheme: str = "order1", max_t=None) -> int:
    """Strip height for one launch on an H100: the threads a wavefront of a
    fused kernel (``d > 0``) runs, or, for the kernels that read a
    precomputed Δ (``d = 0``), the strip of the checkpoint rows that the
    checkpoint forward writes and the backward kernel sweeps (the plain
    forward has no strip: :func:`geometry`).

    The largest power of two that is at most ``max_t`` (a
    ``LaunchConfig.pde_strip`` cap; default 512, or 64 when the launch has
    more than ``_MANY_PROBLEMS`` problems, 128 for the fused kernels), at
    most the refined row count rounded up, at least ``max(2, 2**lam1)``,
    and whose shared memory fits one block: the fused kernel's (at most
    ``kernel.FUSED_MAX_THREADS``), or the backward kernel's (at most
    ``kernel.BWD_MAX_THREADS``).  Raises ValueError when even the smallest
    strip does not fit.
    """
    fused = d > 0
    t_min = max(2, 1 << lam1)
    max_threads = kernel.FUSED_MAX_THREADS if fused else kernel.BWD_MAX_THREADS
    many_t = _MANY_PROBLEMS_FUSED_T if fused else _MANY_PROBLEMS_T
    cap = max_t or (many_t if n_problems > _MANY_PROBLEMS else _FEW_PROBLEMS_T)

    def need(T):
        if fused:
            return kernel.smem_bytes(scheme, T, Ly, lam1, lam2, d)
        return kernel.smem_bytes_bwd(scheme, T, Ly, lam1, lam2)

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


def _geometry(device: str, Lx: int, Ly: int, lam1: int, lam2: int, **kw) -> tuple:
    """The precomputed-Δ forward's geometry (R, warps) for a launch on the
    card; (0, 0) on the CPU, whose plain version has none."""
    return tuple(geometry(Lx, Ly, lam1, lam2, **kw)) if device == "cuda" else (0, 0)


# ---------------------------------------------------------------------------
# the leaf solves as torch.library ops (kernels/_ops.py): the kernel on the
# card, the plain version on the CPU, the output shapes alone under a fake
# tensor; called without inputs that require grad (the autograd.Functions
# below carry the gradients)
# ---------------------------------------------------------------------------

_SCALARS = "int lam1, int lam2, str scheme, str interior_dtype"


def _cps_shape(B: int, Lx: int, Ly: int, T: int, lam1: int, lam2: int, scheme: str):
    return (B, kernel.n_strips(Lx, T, lam1) * kernel.cps_rows(scheme), (Ly << lam2) + T + 1)


#: B1: k̂[nx, ny] (B,) for Δ (B, Lx, Ly); (R, warps) is the card's geometry,
#: (0, 0) on the CPU.
goursat_fwd = define(
    "goursat_fwd", f"(Tensor delta, int R, int warps, {_SCALARS}) -> Tensor",
    lambda delta, *_: delta.new_empty(delta.shape[0]),
    CPU=lambda delta, R, warps, lam1, lam2, scheme, idt:
        kernel.solve_plain(delta, lam1, lam2, scheme, idt),
    CUDA=lambda delta, R, warps, lam1, lam2, scheme, idt:
        kernel.fwd(delta, kernel.FwdGeometry(R, warps), lam1, lam2, scheme, idt))

#: B1-cps: ``(k, cps)`` for Δ (B, Lx, Ly): k̂[nx, ny] and the checkpoint rows at
#: strip height T.
goursat_fwd_cps = define(
    "goursat_fwd_cps",
    f"(Tensor delta, int T, int R, int warps, {_SCALARS}) -> (Tensor, Tensor)",
    lambda delta, T, R, warps, lam1, lam2, scheme, idt: (
        delta.new_empty(delta.shape[0]),
        delta.new_empty(_cps_shape(*delta.shape, T, lam1, lam2, scheme))),
    CPU=lambda delta, T, R, warps, lam1, lam2, scheme, idt:
        kernel.solve_with_grid_plain(delta, T, lam1, lam2, scheme, idt),
    CUDA=lambda delta, T, R, warps, lam1, lam2, scheme, idt:
        kernel.fwd_cps(delta, T, lam1, lam2, scheme, idt, kernel.FwdGeometry(R, warps)))

#: B2: ∂F/∂Δ (B, Lx, Ly) from Δ, the checkpoint rows at strip height T and
#: ḡ (B,).
goursat_bwd = define(
    "goursat_bwd",
    f"(Tensor delta, Tensor cps, Tensor gbar, int T, {_SCALARS}) -> Tensor",
    lambda delta, *_: delta.new_empty(delta.shape),
    CPU=kernel.solve_grad_plain, CUDA=kernel.bwd)

#: B4: k̂[nx, ny] (B,) for matched pairs of increments; T is the card's strip
#: height, 0 on the CPU.
goursat_fwd_fused = define(
    "goursat_fwd_fused", f"(Tensor dx, Tensor dy, int T, {_SCALARS}) -> Tensor",
    lambda dx, dy, *_: dx.new_empty(dx.shape[0]),
    CPU=lambda dx, dy, T, lam1, lam2, scheme, idt:
        kernel.solve_fused_plain(dx, dy, lam1, lam2, scheme, idt),
    CUDA=kernel.fwd_fused)

#: B3: the Gram (Bx, By) from increments; T is the card's strip height, 0 on
#: the CPU.
goursat_gram_fused = define(
    "goursat_gram_fused", f"(Tensor dX, Tensor dY, int T, {_SCALARS}) -> Tensor",
    lambda dX, dY, *_: dX.new_empty(dX.shape[0], dY.shape[0]),
    CPU=lambda dX, dY, T, lam1, lam2, scheme, idt:
        kernel.gram_fused_plain(dX, dY, lam1, lam2, scheme, idt),
    CUDA=kernel.gram_fused)


def solve(delta: torch.Tensor, lam1: int = 0, lam2: int = 0, launch=None,
          scheme: str = "order1", interior_dtype: str = "float32") -> torch.Tensor:
    """Final kernel values for Δ (..., Lx, Ly) -> (...,), differentiable in
    Δ."""
    device = _route(delta)
    if _needs_grad(delta):
        return _Solve.apply(delta, lam1, lam2, launch, scheme, interior_dtype)
    flat = _flat(delta, device)
    _, Lx, Ly = flat.shape
    geo = _geometry(device, Lx, Ly, lam1, lam2, scheme=scheme, max_t=_max_t(launch))
    k = goursat_fwd(flat, *geo, lam1, lam2, scheme, interior_dtype)
    return k.reshape(delta.shape[:-2])


def solve_with_grid(delta: torch.Tensor, lam1: int = 0, lam2: int = 0, launch=None,
                    scheme: str = "order1", interior_dtype: str = "float32"):
    """Forward and the residuals of the exact backward (checkpoint rows,
    not the full grid).  Returns ``(k, cps, T)``; pass T on to
    :func:`solve_grad`."""
    device = _route(delta)
    with spans.span(spans.DELTA):   # a copy where Δ is not in the kernels' layout
        flat = _flat(delta, device)
    B, Lx, Ly = flat.shape
    T = choose_T(Lx, Ly, lam1, lam2, B, scheme=scheme, max_t=_max_t(launch))
    geo = _geometry(device, Lx, Ly, lam1, lam2, scheme=scheme, T=T)
    k, cps = goursat_fwd_cps(flat, T, *geo, lam1, lam2, scheme, interior_dtype)
    return k.reshape(delta.shape[:-2]), cps, T


def solve_grad(delta: torch.Tensor, cps: torch.Tensor, gbar: torch.Tensor, T: int,
               lam1: int = 0, lam2: int = 0, scheme: str = "order1",
               interior_dtype: str = "float32") -> torch.Tensor:
    """Exact ∂F/∂Δ (paper Alg 4) from the checkpoint rows that
    :func:`solve_with_grid` saved at strip height ``T`` (the scheme and the
    interior dtype must be the forward's too: the backward recomputes the
    strip interiors with the same stencil and rounding)."""
    device = _route(delta)
    with spans.span(spans.DELTA):
        flat = _flat(delta, device)
    g = _working(gbar.reshape(-1), device)
    if device == "cpu":
        cps, g = cps.to(flat.dtype), g.to(flat.dtype)
    dd = goursat_bwd(flat, cps, g, T, lam1, lam2, scheme, interior_dtype)
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
        with spans.span(spans.DELTA):
            xw, yw = _working(dx, dx.device.type), _working(dy, dy.device.type)
            delta = stencil.delta_einsum("bid,bjd->bij", xw, yw)
        dd = _rebuilt_grad(delta, gbar, *ctx.args)
        with spans.span(spans.PULLBACK):
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
        with spans.span(spans.DELTA):
            xw, yw = _working(dX, dX.device.type), _working(dY, dY.device.type)
            delta = stencil.delta_einsum("aid,bjd->abij", xw, yw)
        dd = _rebuilt_grad(delta, gbar, *ctx.args)
        with spans.span(spans.PULLBACK):
            # a dot product a pair (over j, or i), then the sum over the other
            # side's paths in float64: the rows' gradients do not depend on how
            # many rows share the launch (row blocks, sharded tiles)
            ddX = (dd @ yw).double().sum(1)
            ddY = (dd.transpose(-1, -2) @ xw[:, None]).double().sum(0)
            return ddX.to(dX.dtype), ddY.to(dY.dtype), None, None, None, None, None


def _solve_fused_forward(dx, dy, lam1, lam2, launch, scheme, interior_dtype):
    device = _route(dx)
    dx, dy = _working(dx, device), _working(dy, device)
    T = 0   # the plain version has no strip
    if device == "cuda":
        B, Lx, d = dx.shape
        T = choose_T(Lx, dy.shape[1], lam1, lam2, B, d=d, scheme=scheme,
                     max_t=_max_t(launch))
    return goursat_fwd_fused(dx, dy, T, lam1, lam2, scheme, interior_dtype)


def _gram_fused_forward(dX, dY, lam1, lam2, launch, scheme, interior_dtype):
    device = _route(dX)
    dX, dY = _working(dX, device), _working(dY, device)
    T = 0
    if device == "cuda":
        Bx, Lx, d = dX.shape
        T = choose_T(Lx, dY.shape[1], lam1, lam2, Bx * dY.shape[0], d=d,
                     scheme=scheme, max_t=_max_t(launch))
    return goursat_gram_fused(dX, dY, T, lam1, lam2, scheme, interior_dtype)


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
