"""Named spans of the port's call paths, on the profiler's timeline.

While a ``torch.profiler`` profile runs, :func:`span` opens a
``record_function`` range, which the profiler keeps in memory with the
host operations and links to every device operation launched inside it: a
reader of the trace can then put each kernel, copy and idle gap in the
step of the program it belongs to.  With the profiler off, :func:`span`
reads one flag and returns a shared null context: no string is formatted,
nothing is allocated and no operator is dispatched.  There is no log of the
port's own and no clock of its own.

A span opens once a call, a row block or a chunk, never once a pair.
:data:`DELTA` and :data:`PULLBACK` never enclose a Goursat op
(``repro_torch::goursat_*``), so the device time under each, and under the
ops, is disjoint.

* ``ENTRY_*``: a public entry point, whole;
* :data:`FRONT_END`: configs, validation, dispatch and the autotune lookup;
* :data:`PREPARE`: the transformed increments (or points) of the paths;
* :data:`DELTA`: a Δ built outside the kernels, the float64 Δ the fused
  backwards rebuild, with its casts, and Δ's copy into the kernels' layout;
* :data:`PULLBACK`: the fused backwards' products, float64 sums and casts
  that carry ∂F/∂Δ back to the increments;
* :data:`SYNC`: a transfer inside a call that blocks the host on the card
  (each one also counted by
  :class:`repro_torch.core.dispatch.count_host_syncs`);
* :data:`COLLECTIVE`: a collective of the sharded Gram, forward or
  backward.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

ENTRY_MMD2 = "repro_torch.mmd2"
ENTRY_SIGKERNEL = "repro_torch.sigkernel"
ENTRY_GRAM = "repro_torch.gram"
ENTRY_GRAM_SHARDED = "repro_torch.gram_sharded"
ENTRY_GRAM_REDUCE = "repro_torch.gram_reduce"
FRONT_END = "repro_torch.front_end"
PREPARE = "repro_torch.prepare"
DELTA = "repro_torch.delta"
PULLBACK = "repro_torch.pullback"
SYNC = "repro_torch.sync"
COLLECTIVE = "repro_torch.collective"

#: every span name above
NAMES = (ENTRY_MMD2, ENTRY_SIGKERNEL, ENTRY_GRAM, ENTRY_GRAM_SHARDED, ENTRY_GRAM_REDUCE,
         FRONT_END, PREPARE, DELTA, PULLBACK, SYNC, COLLECTIVE)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while the profiler
    runs, else a shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: the function's whole body runs under :func:`span`
    ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


__all__ = ["COLLECTIVE", "DELTA", "ENTRY_GRAM", "ENTRY_GRAM_REDUCE", "ENTRY_GRAM_SHARDED",
           "ENTRY_MMD2", "ENTRY_SIGKERNEL", "FRONT_END", "NAMES", "PREPARE", "PULLBACK",
           "SYNC", "span", "spanned"]
