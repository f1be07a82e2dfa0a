"""Wrappers for the Goursat-PDE kernels (forward only).

Counterpart of ``repro/kernels/sigkernel_pde/ops.py``.  Responsibilities:

* dtype discipline: the kernels compute in float32 (bf16/f16 inputs are
  upcast, float64 is cast down as the JAX wrappers do); the CPU path keeps
  at least float32, so float64 stays float64 there;
* batch flattening;
* the strip height T for this card (:func:`choose_T`);
* device routing: a CUDA tensor launches the kernel (or raises), a CPU
  tensor takes the kernel's plain version.  There is no fallback between
  the two.

The zero padding of Lx to the strip (JAX ``ops.py:49-54``, ``:147-149``,
``:201-203``) happens inside the kernels by index arithmetic: rows at or
past Lx read Δ = 0, which is what a zero-padded copy would hold, without
copying Δ.
"""

from __future__ import annotations

import torch

from . import kernel

#: Strip caps from chip_smoke.py's strip sweep on an H100: a launch with
#: few problems (one block per SM) is latency-bound, and tall strips cut its
#: dependent steps (at 1023 x 1023, 512 and 1024 were within run-to-run
#: noise of each other and well ahead of 256); one with more than
#: _MANY_PROBLEMS blocks fills the card several times over, and short
#: strips keep the wavefront's lanes busy (64 beat 128 by ~12% at 128 x 128
#: pairs of 255 x 255, and tied with 32).
_FEW_PROBLEMS_T = 512
_MANY_PROBLEMS = 4 * 132
_MANY_PROBLEMS_T = 64


def require_no_grad(*tensors) -> None:
    """Raise NotImplementedError if any input requires grad: the port has
    no backward yet (ROADMAP item B2)."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise NotImplementedError(
                "repro_torch computes the signature-kernel forward only: the "
                "exact one-pass backward is ROADMAP item B2 and not ported "
                "yet; pass tensors that do not require grad (.detach())")


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def choose_T(Lx: int, Ly: int, lam1: int, lam2: int, n_problems: int, *,
             d: int = 0, scheme: str = "order1", max_t=None) -> int:
    """Strip height (threads per block) for one launch on an H100.

    The largest power of two that is at most ``max_t`` (a
    ``LaunchConfig.pde_strip`` cap; default 512 threads, or 64 when the
    launch has more than ``_MANY_PROBLEMS`` blocks), at most the refined
    row count rounded up, at least ``max(2, 2**lam1)``, and whose shared
    memory fits one block.  Raises ValueError when even the smallest strip
    does not fit.
    """
    fused = d > 0
    t_min = max(2, 1 << lam1)
    cap = max_t or (_MANY_PROBLEMS_T if n_problems > _MANY_PROBLEMS
                    else _FEW_PROBLEMS_T)
    T = max(t_min, min(cap, kernel.MAX_THREADS, _pow2_ceil(Lx << lam1)))
    while T > t_min and kernel.smem_bytes(fused, scheme, T, Ly, lam1, lam2, d) \
            > kernel.SMEM_LIMIT:
        T //= 2
    need = kernel.smem_bytes(fused, scheme, T, Ly, lam1, lam2, d)
    if need > kernel.SMEM_LIMIT or T > kernel.MAX_THREADS:
        raise ValueError(
            f"no Goursat strip fits one H100 block: T={T} needs {need} bytes "
            f"of shared memory (limit {kernel.SMEM_LIMIT}) and at most "
            f"{kernel.MAX_THREADS} threads (ny={Ly << lam2}, lam1={lam1}, "
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


def solve(delta: torch.Tensor, lam1: int = 0, lam2: int = 0, launch=None,
          scheme: str = "order1", interior_dtype: str = "float32") -> torch.Tensor:
    """Final kernel values for Δ (..., Lx, Ly) -> (...,)."""
    require_no_grad(delta)
    device = _route(delta)
    batch_shape = delta.shape[:-2]
    flat = _working(delta.reshape((-1,) + tuple(delta.shape[-2:])), device)
    if device == "cpu":
        k = kernel.solve_plain(flat, lam1, lam2, scheme, interior_dtype)
    else:
        B, Lx, Ly = flat.shape
        T = choose_T(Lx, Ly, lam1, lam2, B, scheme=scheme, max_t=_max_t(launch))
        k = kernel.fwd(flat, T, lam1, lam2, scheme, interior_dtype)
    return k.reshape(batch_shape)


def solve_fused(dx: torch.Tensor, dy: torch.Tensor, lam1: int = 0, lam2: int = 0,
                launch=None, scheme: str = "order1",
                interior_dtype: str = "float32") -> torch.Tensor:
    """k̂ final values from increments directly. dx: (B, Lx, d), dy: (B, Ly, d)."""
    require_no_grad(dx, dy)
    device = _route(dx)
    dx, dy = _working(dx, device), _working(dy, device)
    if device == "cpu":
        return kernel.solve_fused_plain(dx, dy, lam1, lam2, scheme, interior_dtype)
    B, Lx, d = dx.shape
    T = choose_T(Lx, dy.shape[1], lam1, lam2, B, d=d, scheme=scheme,
                 max_t=_max_t(launch))
    return kernel.fwd_fused(dx, dy, T, lam1, lam2, scheme, interior_dtype)


def gram_fused(dX: torch.Tensor, dY: torch.Tensor, lam1: int = 0, lam2: int = 0,
               launch=None, scheme: str = "order1",
               interior_dtype: str = "float32") -> torch.Tensor:
    """Full Gram from increments. dX: (Bx, Lx, d), dY: (By, Ly, d) -> (Bx, By)."""
    require_no_grad(dX, dY)
    device = _route(dX)
    dX, dY = _working(dX, device), _working(dY, device)
    if device == "cpu":
        return kernel.gram_fused_plain(dX, dY, lam1, lam2, scheme, interior_dtype)
    Bx, Lx, d = dX.shape
    T = choose_T(Lx, dY.shape[1], lam1, lam2, Bx * dY.shape[0], d=d,
                 scheme=scheme, max_t=_max_t(launch))
    return kernel.gram_fused(dX, dY, T, lam1, lam2, scheme, interior_dtype)
