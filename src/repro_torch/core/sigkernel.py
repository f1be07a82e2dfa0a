"""Signature kernels via the Goursat PDE (pySigLib §3) and their exact
gradient (§3.4, Alg 4).

Counterpart of ``repro/core/sigkernel.py``.  The scheme (paper eq. (1)),

    k̂_{i+1,j+1} = (k̂_{i+1,j} + k̂_{i,j+1})·A(Δ_{ij}) − k̂_{i,j}·B(Δ_{ij}),

runs over a dyadically refined grid of orders (λ1, λ2); refined cell
(s, t) reads p = Δ[s >> λ1, t >> λ2] · 2^{−(λ1+λ2)}.  Δ comes from one
batched matmul of the transformed increments (:func:`delta_matrix`) or,
for non-linear lifts, from the double increment of a pointwise Gram.
Stencils and the bf16 interior rounding come from
:mod:`repro_torch.kernels.sigkernel_pde.stencil`.

Solvers:

* :func:`solve_goursat` — the row-major scan (the oracle, serial);
* :func:`solve_goursat_antidiag` — the vectorised anti-diagonal wavefront
  (the CPU backend, and the plain version of the CUDA kernels);
* ``backend="gpu"`` / ``"gpu_fused"`` — the hand-written CUDA kernels in
  :mod:`repro_torch.kernels.sigkernel_pde`.

Every route is differentiable with the exact one-pass backward (Alg 4):
:func:`solve_goursat_grad` is the row-scan adjoint (the oracle), the
``antidiag`` backend's backward is the vectorised reverse wavefront
(``kernel.solve_grad_plain``), and the CUDA routes run the checkpoint mode
of the forward kernel and the backward kernel (``ops.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import dispatch
from . import transforms as tf
from .config import (_maybe_scale, delta_from_gram, resolve_kernel_configs,
                     resolve_launch)
from repro_torch.kernels.sigkernel_pde import kernel as pde_kernel
from repro_torch.kernels.sigkernel_pde import ops as pde_ops
from repro_torch.kernels.sigkernel_pde import stencil


def delta_matrix(x: torch.Tensor, y: torch.Tensor, *, transforms=None,
                 static_kernel=None, lengths_x=None,
                 lengths_y=None) -> torch.Tensor:
    """Δ for the Goursat solver: (..., Lx, d) × (..., Ly, d) -> (..., Lx', Ly').

    Linear lift: one batched matmul over the transformed increments,
    Δ[i,j] = scale·⟨dx̃_i, dỹ_j⟩ (outside any kernel, as the JAX package
    leaves it to XLA).  Other lifts: the double increment of the pointwise
    Gram of the materialised transformed paths.  ``lengths_x``/``lengths_y``
    give end-aligned streams (padding → leading zero Δ rows/columns).
    """
    cfg, _, kernel = resolve_kernel_configs(transforms, None, static_kernel)
    if kernel.lifts_increments:
        dx = tf.pipeline_increments(x, cfg, lengths_x, align="end")
        dy = tf.pipeline_increments(y, cfg, lengths_y, align="end")
        return kernel.delta_from_increments(dx, dy)
    xt = tf.transform_path(x, cfg, lengths_x, align="end")
    yt = tf.transform_path(y, cfg, lengths_y, align="end")
    return delta_from_gram(kernel.gram(xt, yt))


def _refine(delta: torch.Tensor, lam1: int, lam2: int) -> torch.Tensor:
    """Refined Δ (..., nx, ny): each entry repeated 2^λ1 × 2^λ2, scaled."""
    if lam1:
        delta = torch.repeat_interleave(delta, 1 << lam1, dim=-2)
    if lam2:
        delta = torch.repeat_interleave(delta, 1 << lam2, dim=-1)
    return delta * 2.0 ** (-(lam1 + lam2))


# ---------------------------------------------------------------------------
# row-major reference scan
# ---------------------------------------------------------------------------

def solve_goursat(delta: torch.Tensor, lam1: int = 0, lam2: int = 0,
                  return_grid: bool = False, scheme: str = "order1",
                  interior_dtype: str = "float32") -> torch.Tensor:
    """Batched Goursat solve by rows then columns, one cell at a time.

    delta: (..., Lx, Ly) -> (...,), or the grid (..., nx+1, ny+1).
    """
    stencil.check_scheme(scheme)
    stencil.check_interior_dtype(interior_dtype)
    batch_shape = delta.shape[:-2]
    Lx, Ly = delta.shape[-2:]
    flat = delta.reshape(-1, Lx, Ly)
    B = flat.shape[0]
    nx, ny = Lx << lam1, Ly << lam2
    P = _refine(flat, lam1, lam2)                     # (B, nx, ny)
    A = stencil.coeff_A(P)
    order2 = scheme == "order2"
    if order2:
        # order-1 fallback on data gridlines (stencil.py): cell (s, t) with
        # s % 2^λ1 == 0 or t % 2^λ2 == 0
        s_idx = torch.arange(nx, device=delta.device)[:, None]
        t_idx = torch.arange(ny, device=delta.device)[None, :]
        edge = ((s_idx % (1 << lam1)) == 0) | ((t_idx % (1 << lam2)) == 0)
        Bc = stencil.coeff_B2_at(P, edge)
        Cc = stencil.coeff_C2_at(P, edge)
    else:
        Bc = stencil.coeff_B1(P)
    ones = torch.ones(B, ny + 1, dtype=flat.dtype, device=flat.device)
    prev_row, prev2_row = ones, ones
    rows = [ones] if return_grid else None
    one = ones[:, 0]
    for s in range(nx):
        left, dl = one, one                           # k̂[s+1, t], k̂[s+1, t−1]
        new = [one]
        for t in range(ny):
            v = (left + prev_row[:, t + 1]) * A[:, s, t] - prev_row[:, t] * Bc[:, s, t]
            if order2:
                v = v - (dl + prev2_row[:, t + 1]) * Cc[:, s, t]
            v = stencil.round_interior(v, interior_dtype)
            dl, left = left, v
            new.append(v)
        prev2_row, prev_row = prev_row, torch.stack(new, dim=1)
        if return_grid:
            rows.append(prev_row)
    if return_grid:
        return torch.stack(rows, dim=1).reshape(*batch_shape, nx + 1, ny + 1)
    return prev_row[:, -1].reshape(batch_shape)


# ---------------------------------------------------------------------------
# vectorised anti-diagonal wavefront
# ---------------------------------------------------------------------------

def _solve_antidiag_flat(delta: torch.Tensor, lam1: int, lam2: int,
                         scheme: str, interior_dtype: str) -> torch.Tensor:
    """Wavefront over a flat batch (B, Lx, Ly) -> (B,).

    All cells of an anti-diagonal are one vector op; the lane axis is the
    shorter refined axis (Δ is transposed when nx > ny, which the stencil
    and its gridline rule are symmetric under).  The order-2 skew
    neighbours both live on the t−2 diagonal: k̂_{i+1,c−1} at the same lane
    (:= 1 for c ≤ 1) and k̂_{i−1,c+1} two lanes down (:= 1 for lanes ≤ 1).
    """
    B = delta.shape[0]
    M = _refine(delta, lam1, lam2)
    nx, ny = M.shape[-2:]
    mlane, mcol = 1 << lam1, 1 << lam2       # data-gridline periods
    if nx > ny:                              # lane = shorter axis
        M = M.transpose(-1, -2)
        nx, ny = ny, nx
        mlane, mcol = mcol, mlane
    dev, dt = delta.device, delta.dtype
    n_diag = nx + ny - 1
    lanes = torch.arange(nx, device=dev)
    # skew once: Msk[t, b, i] = M[b, i, t − i] (0 off the grid)
    t_idx = torch.arange(n_diag, device=dev)[None, :] - lanes[:, None]
    on = (t_idx >= 0) & (t_idx < ny)
    Msk = torch.gather(M, 2, t_idx.clamp(0, ny - 1).expand(B, nx, n_diag))
    Msk = torch.where(on, Msk, torch.zeros((), dtype=dt, device=dev))
    Msk = Msk.permute(2, 0, 1).contiguous()

    prev = torch.zeros(B, nx, dtype=dt, device=dev)
    prev2 = torch.zeros(B, nx, dtype=dt, device=dev)
    one = torch.ones(B, 1, dtype=dt, device=dev)
    order2 = scheme == "order2"
    for t in range(n_diag):
        p = Msk[t]
        first = lanes == t
        up = torch.cat([one, prev[:, :-1]], dim=1)
        upleft = torch.where(first, 1.0, torch.cat([one, prev2[:, :-1]], dim=1))
        left = torch.where(first, 1.0, prev)
        if order2:
            edge = (lanes % mlane == 0) | ((t - lanes) % mcol == 0)
            k_dl = torch.where(lanes >= t - 1, 1.0, prev2)
            k_ul = torch.where(lanes <= 1, 1.0, torch.roll(prev2, 2, dims=1))
            cur = ((left + up) * stencil.coeff_A(p)
                   - upleft * stencil.coeff_B2_at(p, edge)
                   - (k_dl + k_ul) * stencil.coeff_C2_at(p, edge))
        else:
            cur = (left + up) * stencil.coeff_A(p) - upleft * stencil.coeff_B1(p)
        cur = stencil.round_interior(cur, interior_dtype)
        active = (lanes <= t) & (lanes > t - ny)
        prev2, prev = prev, torch.where(active, cur, 0.0)
    return prev[:, nx - 1]


def solve_goursat_antidiag(delta: torch.Tensor, lam1: int = 0, lam2: int = 0,
                           band_chunk: Optional[int] = None,
                           scheme: str = "order1",
                           interior_dtype: str = "float32") -> torch.Tensor:
    """Batched vectorised wavefront solve: (..., Lx, Ly) -> (...,).

    ``band_chunk`` caps how many problems are swept together (bounding the
    live skewed-Δ memory); results do not depend on it.
    """
    stencil.check_scheme(scheme)
    stencil.check_interior_dtype(interior_dtype)
    batch_shape = delta.shape[:-2]
    flat = delta.reshape((-1,) + tuple(delta.shape[-2:]))
    if flat.shape[0] == 0:
        return flat.new_empty(batch_shape)
    chunks = flat.split(band_chunk) if band_chunk else (flat,)
    out = torch.cat([_solve_antidiag_flat(c, lam1, lam2, scheme, interior_dtype)
                     for c in chunks])
    return out.reshape(batch_shape)


# ---------------------------------------------------------------------------
# exact backward (Alg 4) — the row-scan reference
# ---------------------------------------------------------------------------

def _backward_rows(delta: torch.Tensor, grid: torch.Tensor, gbar: torch.Tensor,
                   lam1: int, lam2: int, scheme: str = "order1") -> torch.Tensor:
    """Alg 4 for a flat batch: ∂F/∂Δ (B, Lx, Ly) given the forward grids
    (B, nx+1, ny+1) and the cotangents ḡ (B,).

    Traverses the refined grid bottom-up, one cell at a time, carrying one
    row of g = ∂F/∂k̂ (two rows for ``order2``, whose stencil reaches two
    skew steps).  The recursion does not depend on ``interior_dtype``: the
    rounded forward ``grid`` is all the dΔ terms read, so this is the exact
    straight-through adjoint of the rounded forward.
    """
    B, Lx, Ly = delta.shape
    nx, ny = Lx << lam1, Ly << lam2
    scale = 2.0 ** (-(lam1 + lam2))
    m1, m2 = 1 << lam1, 1 << lam2          # data-gridline periods (stencil.py)
    order2 = scheme == "order2"
    dev, dt = delta.device, delta.dtype
    P = _refine(delta, lam1, lam2)                     # (B, nx, ny)
    A = stencil.coeff_A(P)
    A_one = torch.ones(B, dtype=dt, device=dev)        # A(0): p off the grid
    zero = torch.zeros(B, dtype=dt, device=dev)
    gbar = gbar.to(dt)
    t_idx = torch.arange(ny, device=dev)

    # seed row s = nx: g[nx, ny] = ḡ flows leftward along the row,
    #   g[nx, t] = g[nx, t+1]·A(p[nx-1, t])  [− g[nx, t+2]·C(p[nx-1, t+1])]
    seed = [None] * (ny + 1)
    seed[ny] = gbar
    right, right2 = gbar, zero
    if order2 and lam1 > 0:
        # the C writers are cells (nx-1, t+1); row nx-1 is off-gridline
        # iff λ1 > 0, columns mask per t
        p_sh = torch.cat([P[:, nx - 1, 1:], zero[:, None]], dim=1)
        cq_seed = stencil.coeff_C2_at(p_sh, (t_idx + 1) % m2 == 0)
    for t in range(ny - 1, -1, -1):
        g = right * A[:, nx - 1, t]
        if order2 and lam1 > 0:
            g = g - right2 * cq_seed[:, t]
        seed[t] = g
        right2, right = right, g
    g_below = torch.stack(seed, dim=1)                 # g[s+1, ·]
    g_below2 = torch.zeros_like(g_below)               # g[s+2, ·]

    ddelta = torch.zeros(B, Lx, Ly, dtype=dt, device=dev)
    for s in range(nx - 1, -1, -1):
        p_row = P[:, s]
        # the A coefficients use Δ of *neighbouring* cells (paper eq.):
        #   g[s,t] = g[s+1,t]·A(p[s,t-1]) + g[s,t+1]·A(p[s-1,t]) − g[s+1,t+1]·B(p[s,t])
        # order2 adds  − g[s,t+2]·C(p[s-1,t+1]) − g[s+2,t]·C(p[s+1,t-1])
        a_left = torch.cat([A_one[:, None], A[:, s, :-1]], dim=1)
        a_above = A[:, s - 1] if s >= 1 else torch.ones_like(p_row)
        g_last = g_below[:, ny] * A[:, s, ny - 1]
        if order2:
            p_above = P[:, s - 1] if s >= 1 else torch.zeros_like(p_row)
            p_above_sh = torch.cat([p_above[:, 1:], zero[:, None]], dim=1)
            p_belowrow = P[:, min(s + 1, nx - 1)]
            p_below_sh = torch.cat([zero[:, None], p_belowrow[:, :-1]], dim=1)
            # per-WRITER gridline fallback: the −B writer is cell (s, t),
            # the g[s, t+2] C writer (s-1, t+1), the g[s+2, t] one (s+1, t-1)
            bq = stencil.coeff_B2_at(p_row, (s % m1 == 0) | (t_idx % m2 == 0))
            cq_above = stencil.coeff_C2_at(
                p_above_sh, ((s - 1) % m1 == 0) | ((t_idx + 1) % m2 == 0))
            cq_below = stencil.coeff_C2_at(
                p_below_sh, ((s + 1) % m1 == 0) | ((t_idx - 1) % m2 == 0))
            # cell (s+1, ny-1) reads k̂[s, ny] as its k_ul (−C) unless it
            # sits on a gridline (column ny-1 always does when λ2 == 0)
            if lam2 > 0:
                edge = torch.tensor((s + 1) % m1 == 0, device=dev)
                g_last = g_last - g_below2[:, ny] * stencil.coeff_C2_at(
                    p_belowrow[:, ny - 1], edge)
        else:
            bq = stencil.coeff_B1(p_row)
        row = [None] * ny
        right, right2 = g_last, zero
        for t in range(ny - 1, -1, -1):
            g = (g_below[:, t] * a_left[:, t] + right * a_above[:, t]
                 - g_below[:, t + 1] * bq[:, t])
            if order2:
                g = g - right2 * cq_above[:, t] - g_below2[:, t] * cq_below[:, t]
            row[t] = g
            right2, right = right, g
        g_row = torch.stack(row + [g_last], dim=1)
        # ∂F/∂Δ of row s: cell (s, t) uses g[s+1, t+1]
        k_up, k_below = grid[:, s], grid[:, s + 1]
        if order2:
            cell_edge = (s % m1 == 0) | (t_idx % m2 == 0)
            k_dl = torch.cat([torch.ones_like(k_below[:, :1]), k_below[:, :-2]], dim=1)
            k_ul = grid[:, s - 1, 1:] if s >= 1 else torch.ones_like(p_row)
            contrib = g_below[:, 1:] * (
                (k_below[:, :-1] + k_up[:, 1:]) * stencil.coeff_dA(p_row)
                - k_up[:, :-1] * stencil.coeff_dB2_at(p_row, cell_edge)
                - (k_dl + k_ul) * stencil.coeff_dC2_at(p_row, cell_edge))
        else:
            contrib = g_below[:, 1:] * (
                (k_below[:, :-1] + k_up[:, 1:]) * stencil.coeff_dA(p_row)
                - k_up[:, :-1] * stencil.coeff_dB1(p_row))
        # fold refined t-cells back onto unrefined columns
        ddelta[:, s >> lam1] += contrib.reshape(B, Ly, m2).sum(-1) * scale
        g_below2, g_below = g_below, g_row
    return ddelta


def solve_goursat_grad(delta: torch.Tensor, grid: torch.Tensor, gbar: torch.Tensor,
                       lam1: int = 0, lam2: int = 0, scheme: str = "order1",
                       interior_dtype: str = "float32") -> torch.Tensor:
    """Batched exact backward: (..., Lx, Ly), (..., nx+1, ny+1), (...,) ->
    (..., Lx, Ly).  ``interior_dtype`` only selects the rounded forward
    ``grid`` the caller passes (the adjoint is straight-through)."""
    stencil.check_scheme(scheme)
    stencil.check_interior_dtype(interior_dtype)
    batch_shape = delta.shape[:-2]
    Lx, Ly = delta.shape[-2:]
    flat = delta.reshape(-1, Lx, Ly)
    out = _backward_rows(flat, grid.reshape(flat.shape[0], *grid.shape[-2:]),
                         gbar.reshape(-1), lam1, lam2, scheme)
    return out.reshape(*batch_shape, Lx, Ly)


# ---------------------------------------------------------------------------
# dispatch and the public entry point
# ---------------------------------------------------------------------------

class _SolveDelta(torch.autograd.Function):
    """The ``reference`` and ``antidiag`` solves with the exact one-pass
    backward, under the JAX package's residual policy: ``reference`` keeps
    its grid, ``antidiag`` keeps Δ only and rebuilds in the backward."""

    @staticmethod
    def forward(ctx, delta, g, backend, launch):
        ctx.g, ctx.backend = g, backend
        if backend == "reference":
            grid = solve_goursat(delta, g.lam1, g.lam2, return_grid=True,
                                 scheme=g.scheme, interior_dtype=g.interior_dtype)
            ctx.save_for_backward(delta, grid)
            return grid[..., -1, -1].clone()
        ctx.save_for_backward(delta)
        return solve_goursat_antidiag(delta, g.lam1, g.lam2,
                                      getattr(launch, "band_chunk", None),
                                      g.scheme, g.interior_dtype)

    @staticmethod
    def backward(ctx, gbar):
        g = ctx.g
        if ctx.backend == "reference":
            delta, grid = ctx.saved_tensors
            dd = solve_goursat_grad(delta, grid, gbar, g.lam1, g.lam2, g.scheme,
                                    g.interior_dtype)
        else:
            delta, = ctx.saved_tensors
            dd = _antidiag_grad(delta, gbar, g)
        return dd, None, None, None


def _antidiag_grad(delta: torch.Tensor, gbar: torch.Tensor, g) -> torch.Tensor:
    """The ``antidiag`` backward: one strip over the whole grid (checkpoint
    rows all ones), rebuilt and swept back by the vectorised wavefronts."""
    Lx, Ly = delta.shape[-2:]
    flat = delta.reshape(-1, Lx, Ly)
    T = max(2, Lx << g.lam1)
    rows = 2 if g.scheme == "order2" else 1
    cps = flat.new_ones(flat.shape[0], rows, (Ly << g.lam2) + T + 1)
    dd = pde_kernel.solve_grad_plain(flat, cps, gbar.reshape(-1).to(flat.dtype), T,
                                     g.lam1, g.lam2, g.scheme, g.interior_dtype)
    return dd.reshape(delta.shape)


def _sigkernel_from_delta(delta: torch.Tensor, g, backend: str,
                          launch=None) -> torch.Tensor:
    """Solve batched Goursat problems (..., Lx, Ly) -> (...,) with a
    resolved backend name ("reference" | "antidiag" | "gpu"), differentiable
    in Δ with the exact one-pass backward.  ``g`` is the :class:`GridConfig`."""
    if backend == "gpu":
        return pde_ops.solve(delta, g.lam1, g.lam2, launch, g.scheme, g.interior_dtype)
    if backend not in ("antidiag", "reference"):
        raise ValueError(f"no Δ-solver implementation for backend {backend!r}")
    return _SolveDelta.apply(delta, g, backend, launch)


def sigkernel(x: torch.Tensor, y: torch.Tensor, *, transforms=None, grid=None,
              static_kernel=None, backend: str = "auto", launch=None,
              lengths_x=None, lengths_y=None) -> torch.Tensor:
    """Signature kernel k(x, y) = ⟨S(x̃), S(ỹ)⟩ for batches of paths.

    x: (..., Lx, d), y: (..., Ly, d)  ->  (...,).  Runs where the tensors
    lie: on CUDA ``"auto"`` takes the hand-written kernel (``"gpu"``), on
    the CPU the plain solvers.

    Args:
      transforms: a :class:`TransformPipeline`.
      grid: a :class:`GridConfig` — refinement, stencil, interior dtype.
      static_kernel: :class:`Linear` (default) or :class:`RBF`.
      backend: ``"auto"``, ``"reference"``, ``"antidiag"``, ``"gpu"`` or
        ``"gpu_fused"`` (Δ built inside the kernel; linear lift and matching
        batch shapes only).
      launch: a :class:`LaunchConfig`.
      lengths_x / lengths_y: per-path true point counts for ragged batches;
        k is read at the true ``(len_x, len_y)`` corner.

    Differentiable in ``x`` and ``y`` with the exact one-pass backward.
    """
    cfg, g, kernel = resolve_kernel_configs(transforms, grid, static_kernel)
    launch = resolve_launch(launch)
    if lengths_x is not None:
        x, lengths_x = tf.pad_ragged(x, lengths_x)
    if lengths_y is not None:
        y, lengths_y = tf.pad_ragged(y, lengths_y)
    backend = dispatch.canonicalize(backend, op="sigkernel")
    if backend == "gpu_fused" and not kernel.lifts_increments:
        raise ValueError(
            "backend='gpu_fused' builds Δ from increments inside the kernel and "
            f"only supports the linear lift, got static_kernel="
            f"{type(kernel).__name__}; pass backend='auto'")
    Lx = cfg.transformed_steps(x.shape[-2])
    Ly = cfg.transformed_steps(y.shape[-2])
    backend = dispatch.resolve(backend, op="sigkernel", device=x.device,
                               grid_cells=(Lx << g.lam1) * (Ly << g.lam2),
                               allow_fused=kernel.lifts_increments, scheme=g.scheme)
    if backend == "gpu_fused":
        if x.shape[:-2] != y.shape[:-2]:
            raise ValueError("backend='gpu_fused' needs matching batch shapes, "
                             f"got {tuple(x.shape[:-2])} vs {tuple(y.shape[:-2])}")
        dx = tf.pipeline_increments(x, cfg, lengths_x, align="end")
        dy = tf.pipeline_increments(y, cfg, lengths_y, align="end")
        dx = _maybe_scale(dx, kernel.scale)   # scale·⟨dx, dy⟩ = ⟨scale·dx, dy⟩
        batch_shape = dx.shape[:-2]
        dispatch.record_pair_solves(math.prod(batch_shape))
        k = pde_ops.solve_fused(dx.reshape((-1,) + tuple(dx.shape[-2:])),
                                dy.reshape((-1,) + tuple(dy.shape[-2:])),
                                g.lam1, g.lam2, launch, g.scheme, g.interior_dtype)
        return k.reshape(batch_shape)
    delta = delta_matrix(x, y, transforms=cfg, static_kernel=kernel,
                         lengths_x=lengths_x, lengths_y=lengths_y)
    dispatch.record_pair_solves(math.prod(delta.shape[:-2]))
    return _sigkernel_from_delta(delta, g, backend, launch)
