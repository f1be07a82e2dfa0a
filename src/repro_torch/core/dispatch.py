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
``"rff"`` / ``"nystroem"``
    The feature-map approximations of the Gram
    (:mod:`repro_torch.core.features`), flagged ``approximate=True``:
    :func:`resolve` refuses them for an exact request even when named, and
    ``"auto"`` never returns one.  The Gram entry points opt in with
    ``features=``.  Any device.
``"auto"``
    CUDA tensors: ``"gpu"`` for ``signature``, ``logsignature`` and
    ``sigkernel``; ``"gpu_fused"`` for Grams
    with the linear lift, ``"gpu"`` for other lifts (the TPU rule of the
    JAX package).  CPU tensors: ``"reference"`` for the signature ops; for
    the kernel ops ``"antidiag"`` from ``_ANTIDIAG_MIN_CELLS`` refined
    cells, ``"reference"`` below.

There is no autotune cache, so ``error_budget=`` is not ported.

The op counters (:class:`count_pair_solves`, :class:`count_scan_steps`,
:class:`count_combines`) count on every call: the port has no trace cache,
so a repeated call counts again (the JAX package's count at trace time).
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
    #: feature-map inner products, not the exact kernel: refused unless the
    #: caller opted in (``allow_approximate=True``)
    approximate: bool = False


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
# the feature maps implement the order-1 discretisation only
register(BackendSpec("rff", frozenset({"gram"}), needs_cuda=False,
                     schemes=frozenset({"order1"}), approximate=True))
register(BackendSpec("nystroem", frozenset({"gram"}), needs_cuda=False,
                     schemes=frozenset({"order1"}), approximate=True))


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
            allow_fused: bool = True, allow_approximate: bool = False,
            scheme: str = "order1") -> str:
    """Resolve ``"auto"`` for tensors on ``device``; check a named backend
    against the device and the scheme.

    ``allow_approximate=False`` (the default) means the caller wants the
    exact kernel: a backend flagged ``approximate=True`` is refused even
    when named.  The Gram entry points pass True once ``features=`` opted
    in.  ``"auto"`` never returns an approximate backend."""
    device = torch.device(device)
    if backend != "auto":
        name = canonicalize(backend, op=op)
        if get(name).approximate and not allow_approximate:
            raise ValueError(
                f"backend {name!r} is flagged approximate=True (feature-map "
                f"inner products, not the exact PDE kernel) and an exact "
                f"result was requested; pass features=FeatureConfig(...) to "
                f"opt in, or pick an exact backend: "
                f"{tuple(n for n in backends_for(op) if not get(n).approximate)}")
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
# op accounting: the symmetric Gram's pair-solve saving and the streaming
# Path's scan-free queries are audited with these
# ---------------------------------------------------------------------------

_count_state = threading.local()


class _op_counter:
    """Context manager counting one op kind in this thread:
    ``with count_...() as c: ...; c.total``.  Counts every call."""

    _slot: str = ""

    def __init__(self):
        self.total = 0

    def __enter__(self):
        self._prev = getattr(_count_state, self._slot, None)
        setattr(_count_state, self._slot, self)
        return self

    def __exit__(self, *exc):
        setattr(_count_state, self._slot, self._prev)
        return False


def _record(slot: str, n: int) -> None:
    active = getattr(_count_state, slot, None)
    if active is not None:
        active.total += int(n)


class count_pair_solves(_op_counter):
    """Counts Goursat pair solves (the problems each solver call is given)."""

    _slot = "pair"


class count_scan_steps(_op_counter):
    """Counts Horner scan steps of the plain scans (one per increment
    folded); the Horner kernel (one launch, not a scan) reports none."""

    _slot = "scan"


class count_combines(_op_counter):
    """Counts Chen combines issued by the streaming ``Path``."""

    _slot = "combine"


def record_pair_solves(n: int) -> None:
    """Report ``n`` pair solves to the active counter (no-op otherwise)."""
    _record("pair", n)


def record_scan_steps(n: int) -> None:
    """Report ``n`` Horner scan steps to the active counter."""
    _record("scan", n)


def record_combines(n: int) -> None:
    """Report ``n`` Chen combines to the active counter."""
    _record("combine", n)
