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
    The measured winner from the autotune cache
    (:mod:`repro_torch.bench.autotune`) when one exists for the (op,
    device type, dtype, shape bucket) key and this machine; otherwise the
    static rule.  CUDA tensors: ``"gpu"`` for ``signature``,
    ``logsignature`` and ``sigkernel``; ``"gpu_fused"`` for Grams with the
    linear lift, ``"gpu"`` for other lifts (the TPU rule of the JAX
    package).  CPU tensors: ``"reference"`` for the signature ops; for the
    kernel ops ``"antidiag"`` from ``_ANTIDIAG_MIN_CELLS`` refined cells,
    ``"reference"`` below.

``error_budget=`` on the Gram and loss entry points goes through
:func:`resolve_approx` (a measured RFF / Nyström point) and
:func:`resolve_scheme` (a measured cheaper discretisation of the exact
engine); a cold cache, a foreign machine or no qualifying point gives the
exact engine.

The op counters (:class:`count_pair_solves`, :class:`count_scan_steps`,
:class:`count_combines`, :class:`count_host_syncs`) count on every call:
the port has no trace cache, so a repeated call counts again (the JAX
package's count at trace time).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, FrozenSet, Optional, Tuple

import torch

from repro_torch.kernels.sigkernel_pde.stencil import INTERIOR_DTYPES, SCHEMES

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
    #: builds Δ from the increments inside the kernel: the linear lift only
    fused: bool = False


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
register(BackendSpec("gpu_fused", frozenset(PDE_OPS), needs_cuda=True, fused=True))
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


def _autotuned(op: str, shape, dtype, device: torch.device,
               ragged: bool = False) -> Optional[str]:
    """Winning backend from the autotune cache, or None (-> the static rule).

    None whenever the cache is cold, autotuning is disabled
    (``REPRO_DISABLE_AUTOTUNE=1``), the file is unreadable, the entry was
    tuned on another machine, the name no longer denotes a live backend
    serving ``op``, or it names CUDA kernels for tensors off the card or an
    approximation (the budgeted route is :func:`resolve_approx`).  A lookup
    never measures: tuning happens only through
    :func:`repro_torch.bench.autotune.tune`.
    """
    if shape is None:
        return None
    from repro_torch.bench import autotune
    if not autotune.enabled():
        return None
    try:
        name = autotune.lookup(op, shape, dtype or "float32", device=device,
                               ragged=ragged)
    except (ValueError, TypeError):
        return None
    spec = _REGISTRY.get(name)
    if spec is None or op not in spec.ops:
        return None   # stale entry: backend renamed or removed since tuning
    if spec.needs_cuda and torch.device(device).type != "cuda":
        return None   # never let an entry send CPU tensors to the kernels
    if spec.approximate:
        return None   # an exact request never gets an approximation
    return name


def resolve(backend: str, *, op: str, device: torch.device, grid_cells=None,
            shape=None, dtype=None, allow_fused: bool = True, ragged: bool = False,
            allow_approximate: bool = False, scheme: str = "order1") -> str:
    """Resolve ``"auto"`` for tensors on ``device``; check a named backend
    against the device and the scheme.

    With ``shape`` (the per-op key shape of
    :func:`repro_torch.bench.autotune.key_shape`) ``"auto"`` first takes the
    autotune cache's measured winner for this key (``ragged`` keeps
    ``lengths=`` workloads apart), unless it is a fused backend where
    ``allow_fused=False`` or lacks ``scheme``; otherwise the static rule.

    ``allow_approximate=False`` (the default) means the caller wants the
    exact kernel: a backend flagged ``approximate=True`` is refused even
    when named.  The Gram entry points pass True once ``features=`` or
    ``error_budget=`` opted in.  ``"auto"`` never returns an approximate
    backend (the budgeted route is :func:`resolve_approx`)."""
    device = torch.device(device)
    if backend != "auto":
        name = canonicalize(backend, op=op)
        if get(name).approximate and not allow_approximate:
            raise ValueError(
                f"backend {name!r} is flagged approximate=True (feature-map "
                f"inner products, not the exact PDE kernel) and an exact "
                f"result was requested; pass features=FeatureConfig(...) or "
                f"error_budget= to opt in, or pick an exact backend: "
                f"{tuple(n for n in backends_for(op) if not get(n).approximate)}")
        if get(name).needs_cuda and device.type != "cuda":
            raise ValueError(
                f"backend {name!r} runs the hand-written CUDA kernels and needs "
                f"CUDA tensors, got tensors on {device}; move them to 'cuda' "
                f"or pass backend='auto' (the CPU runs the plain versions)")
        return check_scheme(name, scheme, op=op)
    tuned = _autotuned(op, shape, dtype, device, ragged)
    if tuned is not None and (allow_fused or not get(tuned).fused) \
            and scheme in get(tuned).schemes:
        return tuned
    if device.type == "cuda":
        name = "gpu_fused" if op == "gram" and allow_fused else "gpu"
    elif grid_cells is not None and grid_cells >= _ANTIDIAG_MIN_CELLS:
        name = "antidiag"
    else:
        name = "reference"
    return check_scheme(name, scheme, op=op)


def resolve_approx(op: str, shape=None, dtype=None, *, device: torch.device,
                   error_budget, ragged: bool = False) -> Optional[Tuple[str, int]]:
    """Cheapest approximate backend meeting ``error_budget``, or None.

    The only road by which ``"auto"`` may land on an approximate backend:
    the caller gave a relative-error budget, and the autotune cache holds a
    measured frontier for this key
    (:func:`repro_torch.bench.autotune.tune_frontier`) with a point that fits
    it and beat the exact engine on this machine.  Returns ``(name, rank)``;
    None under the same fail-open rule as :func:`_autotuned`.
    """
    if shape is None or error_budget is None:
        return None
    from repro_torch.bench import autotune
    if not autotune.enabled():
        return None
    try:
        found = autotune.lookup_budget(op, shape, dtype or "float32", error_budget,
                                       device=device, ragged=ragged)
    except (ValueError, TypeError):
        return None
    if found is None:
        return None
    name, rank = found
    spec = _REGISTRY.get(name)
    if spec is None or op not in spec.ops or not spec.approximate:
        return None   # stale frontier entry
    return name, int(rank)


def resolve_scheme(op: str, shape=None, dtype=None, *, device: torch.device,
                   error_budget, ragged: bool = False
                   ) -> Optional[Tuple[str, int, str]]:
    """Cheapest measured *discretisation* meeting ``error_budget``, or None.

    The exact-engine sibling of :func:`resolve_approx`: the scheme frontier
    (:func:`repro_torch.bench.autotune.tune_scheme_frontier`) holds measured
    ``(scheme, coarsen, interior_dtype)`` points with their relative error
    against the order-1 fine-grid f32 Gram.  Returns the cheapest one that
    fits the budget and beat that baseline on this machine, or None under
    the same fail-open rule.  The Gram engine consults it only from the
    default ``GridConfig`` scheme and interior dtype.
    """
    if shape is None or error_budget is None:
        return None
    from repro_torch.bench import autotune
    if not autotune.enabled():
        return None
    try:
        found = autotune.lookup_scheme_budget(op, shape, dtype or "float32",
                                              error_budget, device=device,
                                              ragged=ragged)
    except (ValueError, TypeError):
        return None
    if found is None:
        return None
    scheme, coarsen, idt = found
    if scheme not in SCHEMES or idt not in INTERIOR_DTYPES:
        return None   # stale frontier entry
    return scheme, int(coarsen), idt


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


class count_host_syncs(_op_counter):
    """Counts the transfers inside a call that block the host on the card
    (each under a ``repro_torch.sync`` span, :mod:`repro_torch.spans`).
    The same sites count on every device: on CPU tensors nothing waits, and
    the count is the card's."""

    _slot = "sync"


@contextlib.contextmanager
def paused_counters():
    """No op counter of this thread records within: a trace that runs
    nothing (the streaming guard of ``core/gram.py``) leaves them as they
    were."""
    slots = ("pair", "scan", "combine", "sync")
    saved = [getattr(_count_state, s, None) for s in slots]
    for s in slots:
        setattr(_count_state, s, None)
    try:
        yield
    finally:
        for s, v in zip(slots, saved):
            setattr(_count_state, s, v)


def record_pair_solves(n: int) -> None:
    """Report ``n`` pair solves to the active counter (no-op otherwise)."""
    _record("pair", n)


def record_scan_steps(n: int) -> None:
    """Report ``n`` Horner scan steps to the active counter."""
    _record("scan", n)


def record_combines(n: int) -> None:
    """Report ``n`` Chen combines to the active counter."""
    _record("combine", n)


def record_host_syncs(n: int) -> None:
    """Report ``n`` blocking host-card transfers to the active counter."""
    _record("sync", n)
