"""Backend registry and dispatch for the signature and signature-kernel ops.

Counterpart of ``repro/core/dispatch.py`` (the parts the ported paths
need).  Registered backends:

``"reference"``
    Plain PyTorch: the Horner scan for ``signature``/``logsignature``, the
    row-major Goursat scan (oracle-grade, serial) for the kernel ops.  Any
    device.
``"antidiag"``
    Plain PyTorch vectorised anti-diagonal wavefront (kernel ops only).
    Any device.
``"gpu"``
    The hand-written CUDA kernels (the counterpart of ``"pallas"``): the
    Horner kernel for ``signature``/``logsignature``, the Goursat kernel
    over a precomputed Δ for the kernel ops.  CUDA tensors only.
``"gpu_fused"``
    The CUDA kernels that build Δ from increments inside the kernel (the
    counterpart of ``"pallas_fused"``); linear lift only.  CUDA tensors
    only.
``"auto"``
    CUDA tensors: ``"gpu"`` for ``signature``, ``logsignature`` and
    ``sigkernel``; ``"gpu_fused"`` for Grams
    with the linear lift, ``"gpu"`` for other lifts (the TPU rule of the
    JAX package).  CPU tensors: ``"reference"`` for the signature ops; for
    the kernel ops ``"antidiag"`` from ``_ANTIDIAG_MIN_CELLS`` refined
    cells, ``"reference"`` below.

There is no autotune cache and no approximate backend in this slice.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, FrozenSet, Tuple

import torch

from repro_torch.kernels.sigkernel_pde.stencil import SCHEMES

#: ops a backend can serve
OPS = ("signature", "logsignature", "sigkernel", "gram")
#: the signature-kernel ops (the Goursat solvers)
PDE_OPS = ("sigkernel", "gram")

#: below this many refined PDE cells the serial reference scan is used on
#: the CPU (the wavefront's skew overhead dominates tiny grids)
_ANTIDIAG_MIN_CELLS = 4096


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability card for one named backend."""

    name: str
    ops: FrozenSet[str]
    #: runs the hand-written CUDA kernels: CUDA tensors only
    needs_cuda: bool
    #: Goursat stencils this backend implements
    schemes: FrozenSet[str] = frozenset(SCHEMES)


_REGISTRY: Dict[str, BackendSpec] = {}


def register(spec: BackendSpec) -> BackendSpec:
    """Add (or replace) a backend in the registry."""
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> BackendSpec:
    """Look up a backend by name; raise with the known names otherwise."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)} "
            f"(plus 'auto')") from None


def backends_for(op: str) -> Tuple[str, ...]:
    """Names of all registered backends that serve ``op``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; known: {OPS}")
    return tuple(sorted(n for n, s in _REGISTRY.items() if op in s.ops))


register(BackendSpec("reference", frozenset(OPS), needs_cuda=False))
register(BackendSpec("antidiag", frozenset(PDE_OPS), needs_cuda=False))
register(BackendSpec("gpu", frozenset(OPS), needs_cuda=True))
register(BackendSpec("gpu_fused", frozenset(PDE_OPS), needs_cuda=True))


def check_scheme(backend: str, scheme: str, *, op: str) -> str:
    """Refuse a backend that does not implement the requested stencil."""
    spec = get(backend)
    if scheme not in spec.schemes:
        capable = tuple(n for n in backends_for(op) if scheme in get(n).schemes)
        raise ValueError(
            f"backend {backend!r} does not implement GridConfig.scheme="
            f"{scheme!r} (it supports {tuple(sorted(spec.schemes))}); schemes "
            f"are never silently downgraded — pick one of {capable}")
    return backend


def canonicalize(backend: str, *, op: str) -> str:
    """Validate a backend name for ``op``; ``"auto"`` passes through."""
    if backend == "auto":
        return backend
    spec = get(backend)
    if op not in spec.ops:
        raise ValueError(f"backend {backend!r} does not implement op {op!r}; "
                         f"options: {backends_for(op)}")
    return backend


def resolve(backend: str, *, op: str, device: torch.device, grid_cells=None,
            allow_fused: bool = True, scheme: str = "order1") -> str:
    """Resolve ``"auto"`` for tensors on ``device``; check a named backend
    against the device and the scheme."""
    device = torch.device(device)
    if backend != "auto":
        name = canonicalize(backend, op=op)
        if get(name).needs_cuda and device.type != "cuda":
            raise ValueError(
                f"backend {name!r} runs the hand-written CUDA kernels and needs "
                f"CUDA tensors, got tensors on {device}; move them to 'cuda' "
                f"or pass backend='auto' (the CPU runs the plain versions)")
        return check_scheme(name, scheme, op=op)
    if device.type == "cuda":
        name = "gpu_fused" if op == "gram" and allow_fused else "gpu"
    elif grid_cells is not None and grid_cells >= _ANTIDIAG_MIN_CELLS:
        name = "antidiag"
    else:
        name = "reference"
    return check_scheme(name, scheme, op=op)


# ---------------------------------------------------------------------------
# op accounting: the symmetric Gram's pair-solve saving is audited with it
# ---------------------------------------------------------------------------

_count_state = threading.local()


class count_pair_solves:
    """Context manager counting Goursat pair solves in this thread:
    ``with count_pair_solves() as c: ...; c.total``."""

    def __init__(self):
        self.total = 0

    def __enter__(self):
        self._prev = getattr(_count_state, "pair", None)
        _count_state.pair = self
        return self

    def __exit__(self, *exc):
        _count_state.pair = self._prev
        return False


def record_pair_solves(n: int) -> None:
    """Report ``n`` pair solves to the active counter (no-op otherwise)."""
    active = getattr(_count_state, "pair", None)
    if active is not None:
        active.total += int(n)
