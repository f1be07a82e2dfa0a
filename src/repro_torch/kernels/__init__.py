"""Hand-written Hopper kernels of the port."""

from __future__ import annotations

import torch


def available() -> bool:
    """Whether CUDA is present and every kernel library built and loaded
    (the Goursat kernels and the Horner kernel).

    Information only: the wrappers never consult it.  A CUDA tensor
    launches a kernel or raises; a CPU tensor takes the plain version.
    """
    if not torch.cuda.is_available():
        return False
    from .signature import kernel as signature_kernel
    from .sigkernel_pde import kernel as sigkernel_kernel
    try:
        for lib in (sigkernel_kernel, signature_kernel):
            lib.library()
    except (RuntimeError, OSError):
        return False
    return True


__all__ = ["available"]
