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
from .core.features import resolve_features
from .core.logsignature import logsignature as _logsignature
from .core.signature import signature as _signature
from .core.sigkernel import sigkernel as _sigkernel


def card_device(device, owner: str) -> torch.device:
    """The device of a class-level entry point: ``None`` means ``"cuda"``,
    and a CUDA device raises when CUDA is missing (no fallback to the CPU;
    ``device="cpu"`` asks for it)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner} runs on the card by default and CUDA is not "
            f"available; pass device='cpu' for the plain CPU versions")
    return device


class _OnDevice(nn.Module):
    """A module bound to one device (:func:`card_device`); inputs are moved
    there."""

    def __init__(self, device):
        super().__init__()
        self.device = card_device(device, type(self).__name__)

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
    backend="auto", features=None, error_budget=None, device=None)`` exposes
    ``forward(x, y)`` (k for batched path pairs), ``gram(X, Y=None)``,
    ``mmd2(X, Y)`` and ``scoring_rule(X, y)``.  ``features=`` (a
    :class:`FeatureConfig`) switches ``gram``, ``mmd2`` and ``scoring_rule``
    to the approximate feature map it names; ``error_budget=`` instead lets
    ``backend="auto"`` take a cheaper engine the autotune cache measured
    within the budget.  ``forward`` stays exact.

    ``device=None`` means ``"cuda"`` and raises if CUDA is missing; pass
    ``device="cpu"`` to run the plain solvers on the CPU.  All are
    differentiable in their paths with the exact one-pass backward (a path
    that requires grad and lies elsewhere is moved with ``.to``, which
    autograd follows).
    """

    def __init__(self, static_kernel=None, transforms=None, grid=None,
                 backend: str = "auto", features=None, error_budget=None,
                 device=None):
        super().__init__(device)
        self.transforms, self.grid, self.static_kernel = resolve_kernel_configs(
            transforms, grid, static_kernel)
        self.backend = backend
        self.features = resolve_features(features)
        self.error_budget = error_budget

    def _kw(self):
        return dict(transforms=self.transforms, grid=self.grid,
                    static_kernel=self.static_kernel, backend=self.backend)

    def _gram_kw(self):
        return dict(self._kw(), features=self.features, error_budget=self.error_budget)

    def forward(self, x, y, *, lengths_x=None, lengths_y=None) -> torch.Tensor:
        return _sigkernel(self._on(x), self._on(y), lengths_x=lengths_x,
                          lengths_y=lengths_y, **self._kw())

    def gram(self, X, Y=None, *, row_block: Optional[int] = None,
             symmetric: Optional[bool] = None, lengths=None,
             lengths_y=None) -> torch.Tensor:
        return _gram.sigkernel_gram(self._on(X), self._on(Y), row_block=row_block,
                                    symmetric=symmetric, lengths=lengths,
                                    lengths_y=lengths_y, **self._gram_kw())

    def mmd2(self, X, Y, *, unbiased: bool = True, row_block: Optional[int] = None,
             streaming: Optional[bool] = None, lengths=None,
             lengths_y=None) -> torch.Tensor:
        return _losses.mmd2(self._on(X), self._on(Y), unbiased=unbiased,
                            row_block=row_block, streaming=streaming,
                            lengths=lengths, lengths_y=lengths_y,
                            **self._gram_kw())

    def scoring_rule(self, X, y, *, row_block: Optional[int] = None,
                     streaming: Optional[bool] = None, lengths=None,
                     length_y=None) -> torch.Tensor:
        return _losses.scoring_rule(self._on(X), self._on(y), row_block=row_block,
                                    streaming=streaming, lengths=lengths,
                                    length_y=length_y, **self._gram_kw())
