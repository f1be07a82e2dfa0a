"""Class-style entry points: :class:`Signature`, :class:`LogSignature` and
:class:`SigKernel` as ``nn.Module``s.

Counterpart of ``repro/api.py``.  Each module holds its configuration and a
device; inputs are moved to that device, and the functional API in
:mod:`repro_torch.core` does the work.  ``device=None`` means ``"cuda"`` and
raises if CUDA is missing; ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .core import gram as _gram
from .core import losses as _losses
from .core.config import resolve_kernel_configs
from .core.logsignature import logsignature as _logsignature
from .core.signature import signature as _signature
from .core.sigkernel import sigkernel as _sigkernel


class _OnDevice(nn.Module):
    """A module bound to one device: ``device=None`` means ``"cuda"`` and
    raises if CUDA is missing; inputs are moved there."""

    def __init__(self, device):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__} runs on the card by default and CUDA is not "
                f"available; pass device='cpu' for the plain CPU versions")
        self.device = device

    def _on(self, t):
        return None if t is None else torch.as_tensor(t, device=self.device)


class Signature(_OnDevice):
    """Truncated path signature as a configured module.

    ``Signature(depth, transforms=..., backend=..., stream=..., device=None)``;
    ``forward(path, lengths=None)`` maps (..., L, d) paths to flat
    signatures (ragged with ``lengths=``).  Differentiable in ``path``.
    """

    def __init__(self, depth: int, transforms=None, backend: str = "auto",
                 stream: bool = False, device=None):
        super().__init__(device)
        self.depth = depth
        self.transforms = resolve_kernel_configs(transforms, None, None)[0]
        self.backend = backend
        self.stream = stream

    def forward(self, path, lengths=None) -> torch.Tensor:
        return _signature(self._on(path), self.depth, transforms=self.transforms,
                          backend=self.backend, stream=self.stream, lengths=lengths)


class LogSignature(Signature):
    """Truncated log-signature (Lyndon-compressed by default) as a
    configured module; ``mode`` is ``"lyndon"``, ``"brackets"`` or
    ``"expand"``.  Otherwise as :class:`Signature`."""

    def __init__(self, depth: int, mode: str = "lyndon", transforms=None,
                 backend: str = "auto", stream: bool = False, device=None):
        super().__init__(depth, transforms, backend, stream, device)
        self.mode = mode

    def forward(self, path, lengths=None) -> torch.Tensor:
        return _logsignature(self._on(path), self.depth, mode=self.mode,
                             transforms=self.transforms, backend=self.backend,
                             stream=self.stream, lengths=lengths)


class SigKernel(_OnDevice):
    """Signature kernel with a swappable static-kernel lift.

    ``SigKernel(static_kernel=Linear()|RBF(...), transforms=..., grid=...,
    backend="auto", device=None)`` exposes ``forward(x, y)`` (k for batched
    path pairs), ``gram(X, Y=None)``, ``mmd2(X, Y)`` and
    ``scoring_rule(X, y)``.

    ``device=None`` means ``"cuda"`` and raises if CUDA is missing; pass
    ``device="cpu"`` to run the plain solvers on the CPU.  All are
    differentiable in their paths with the exact one-pass backward (a path
    that requires grad and lies elsewhere is moved with ``.to``, which
    autograd follows).
    """

    def __init__(self, static_kernel=None, transforms=None, grid=None,
                 backend: str = "auto", device=None):
        super().__init__(device)
        self.transforms, self.grid, self.static_kernel = resolve_kernel_configs(
            transforms, grid, static_kernel)
        self.backend = backend

    def _kw(self):
        return dict(transforms=self.transforms, grid=self.grid,
                    static_kernel=self.static_kernel, backend=self.backend)

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

    def scoring_rule(self, X, y, *, row_block: Optional[int] = None,
                     streaming: Optional[bool] = None, lengths=None,
                     length_y=None) -> torch.Tensor:
        return _losses.scoring_rule(self._on(X), self._on(y), row_block=row_block,
                                    streaming=streaming, lengths=lengths,
                                    length_y=length_y, **self._kw())
