"""Goursat-PDE signature-kernel solver: the forward and backward Hopper
kernels (``kernel.py``, ``csrc/sigkernel_pde.cu``), their wrappers
(``ops.py``), the stencils (``stencil.py``) and the oracle (``ref.py``)."""

from .ops import (choose_T, gram_fused, solve, solve_fused, solve_grad,
                  solve_with_grid)

__all__ = ["choose_T", "gram_fused", "solve", "solve_fused", "solve_grad",
           "solve_with_grid"]
