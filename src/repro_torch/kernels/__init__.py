"""Hand-written Hopper kernels of the port."""

from __future__ import annotations

import torch


def available() -> bool:
    """Whether CUDA is present and the kernels built and loaded.

    Information only: the wrappers never consult it.  A CUDA tensor
    launches a kernel or raises; a CPU tensor takes the plain version.
    """
    if not torch.cuda.is_available():
        return False
    from .sigkernel_pde import kernel
    try:
        kernel.library()
    except (RuntimeError, OSError):
        return False
    return True


__all__ = ["available"]
