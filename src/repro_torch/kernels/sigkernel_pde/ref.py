"""Oracle wrappers for the sig-kernel PDE kernels.

Counterpart of ``repro/kernels/sigkernel_pde/ref.py`` (forward parts):
delegates to the row-scan reference in :mod:`repro_torch.core.sigkernel`.
"""

from __future__ import annotations

import torch


def solve(delta: torch.Tensor, lam1: int = 0, lam2: int = 0,
          scheme: str = "order1", interior_dtype: str = "float32") -> torch.Tensor:
    """Final kernel values k̂[nx, ny] for a batch of Δ matrices (..., Lx, Ly)."""
    from repro_torch.core.sigkernel import solve_goursat
    return solve_goursat(delta, lam1, lam2, scheme=scheme,
                         interior_dtype=interior_dtype)


def solve_grid(delta: torch.Tensor, lam1: int = 0, lam2: int = 0,
               scheme: str = "order1", interior_dtype: str = "float32") -> torch.Tensor:
    """Full refined PDE grids (..., nx+1, ny+1)."""
    from repro_torch.core.sigkernel import solve_goursat
    return solve_goursat(delta, lam1, lam2, return_grid=True, scheme=scheme,
                         interior_dtype=interior_dtype)
