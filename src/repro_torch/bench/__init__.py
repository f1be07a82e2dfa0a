"""The benchmark suite of the PyTorch port.

Counterpart of ``repro.bench``: the paper's speed claims as a recorded,
gated document, and the autotune cache that ``backend="auto"`` and
``error_budget=`` read.

``autotune``
    Measured backend winners and the two error-budget frontiers (RFF /
    Nyström rank, stencil × grid × interior precision), persisted in a JSON
    cache keyed by (op, device type, dtype, shape bucket) and stamped with
    the machine; :mod:`repro_torch.core.dispatch` reads it, never measuring.
``timer``
    Steady-state timing (warm-up calls, then the minimum wall time over
    repeats, every call fenced by ``torch.cuda.synchronize()`` on the card
    — paper §5 methodology) and a machine fingerprint with the card's name
    and power limit.
``roofline``
    Achieved vs. peak FLOPs/bandwidth for every bench entry, from analytic
    per-op counts (the same model as the JAX package's, whatever computes
    the entry), against the H100 data-sheet peaks on the card.  CLI:
    ``python -m repro_torch.bench.roofline BENCH_TORCH_full.json``.
``workloads``
    The paper-aligned workload cells (signature Table 1, sig-kernel Table 2
    + Gram rows, log-signature Table 3, Figs 1-2, §3.4 gradient accuracy,
    the streaming ``Path``, the two frontiers) at smoke / quick / full
    sizes, plus the smoke checks and the autotune round trip.
``suite``
    Runs a set of workloads and emits a schema-versioned BENCH JSON and a
    markdown summary.  CLI: ``python -m repro_torch.bench [--smoke|--full]``.
``compare``
    Diffs two BENCH JSONs of the port with machine-speed normalisation and
    per-entry tolerances; exits nonzero on regression.  CLI:
    ``python -m repro_torch.bench.compare OLD NEW``.
"""

import importlib

__all__ = ["autotune", "compare", "roofline", "suite", "timer", "workloads"]


def __getattr__(name):
    # lazy submodule access (PEP 562): keeps `import repro_torch.bench` light
    # and avoids runpy's double-import warning for `python -m ...compare`
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
