"""Class-style entry point: :class:`SigKernel` as an ``nn.Module``.

Counterpart of ``repro/api.py`` (``Signature``/``LogSignature`` come with
the signature slice).  The module holds its configs and a device; inputs
are moved to that device, and the functional API in :mod:`repro_torch.core`
does the work.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .core import gram as _gram
from .core import losses as _losses
from .core.config import resolve_kernel_configs
from .core.sigkernel import sigkernel as _sigkernel


class SigKernel(nn.Module):
    """Signature kernel with a swappable static-kernel lift.

    ``SigKernel(static_kernel=Linear()|RBF(...), transforms=..., grid=...,
    backend="auto", device=None)`` exposes ``forward(x, y)`` (k for batched
    path pairs), ``gram(X, Y=None)`` and ``mmd2(X, Y)``.

    ``device=None`` means ``"cuda"`` and raises if CUDA is missing; pass
    ``device="cpu"`` to run the plain solvers on the CPU.  All three are
    differentiable in their paths with the exact one-pass backward (a path
    that requires grad and lies elsewhere is moved with ``.to``, which
    autograd follows).
    """

    def __init__(self, static_kernel=None, transforms=None, grid=None,
                 backend: str = "auto", device=None):
        super().__init__()
        self.transforms, self.grid, self.static_kernel = resolve_kernel_configs(
            transforms, grid, static_kernel)
        self.backend = backend
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SigKernel runs on the card by default and CUDA is not "
                "available; pass device='cpu' for the plain CPU solvers")
        self.device = device

    def _kw(self):
        return dict(transforms=self.transforms, grid=self.grid,
                    static_kernel=self.static_kernel, backend=self.backend)

    def _on(self, t):
        return None if t is None else torch.as_tensor(t, device=self.device)

    def forward(self, x, y, *, lengths_x=None, lengths_y=None) -> torch.Tensor:
        return _sigkernel(self._on(x), self._on(y), lengths_x=lengths_x,
                          lengths_y=lengths_y, **self._kw())

    def gram(self, X, Y=None, *, row_block: Optional[int] = None,
             symmetric: Optional[bool] = None, lengths=None,
             lengths_y=None) -> torch.Tensor:
        return _gram.sigkernel_gram(self._on(X), self._on(Y), row_block=row_block,
                                    symmetric=symmetric, lengths=lengths,
                                    lengths_y=lengths_y, **self._kw())

    def mmd2(self, X, Y, *, unbiased: bool = True, row_block: Optional[int] = None,
             streaming: Optional[bool] = None, lengths=None,
             lengths_y=None) -> torch.Tensor:
        return _losses.mmd2(self._on(X), self._on(Y), unbiased=unbiased,
                            row_block=row_block, streaming=streaming,
                            lengths=lengths, lengths_y=lengths_y, **self._kw())
