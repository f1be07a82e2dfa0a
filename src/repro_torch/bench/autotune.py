"""Measurement-driven backend selection and the two error-budget frontiers.

Counterpart of ``repro.bench.autotune``.  :func:`tune` times every exact
backend of :mod:`repro_torch.core.dispatch` that can serve an op on a
device (the CUDA kernels only for card tensors) and persists the winner in
an on-disk JSON cache keyed by ``(op, device type, dtype, shape bucket)``.
:func:`lookup` is the read side: :func:`repro_torch.core.dispatch.resolve`
consults it when resolving ``"auto"`` and falls back to its static rule
whenever the answer is ``None``.  :func:`tune_frontier` (RFF / Nyström
rank against relative error) and :func:`tune_scheme_frontier` (stencil
order × grid coarseness × interior precision) measure what
``error_budget=`` may trade for speed; :func:`lookup_budget` and
:func:`lookup_scheme_budget` read them.

Design points (as in the JAX package):

* **Shape buckets** — batch- and length-like dimensions of the key shape
  are rounded up to the next power of two; channel count and depth stay
  exact.  :func:`tune` measures at the bucketed shape.
* **Lookups never time anything** — a warm cache costs one memoised JSON
  read per process (one ``os.stat`` a lookup); ``tune`` on a warm key
  returns the stored winner without a measurement unless ``force=True``.
* **Fail open** — a corrupt file, another schema (a JAX-package cache file
  among them: its integer schema never equals this module's tag, and the
  JAX package reads this module's files as cold in turn), an entry naming
  a backend that no longer exists, or an entry stamped by another machine
  (:func:`repro_torch.bench.timer.machine_key`: device type, the card's
  name and memory) reads as a cold cache, never an error.

Where the port differs:

* **The key's platform field is the tensors' device type** (``"cpu"`` /
  ``"cuda"``), from every function's ``device=`` argument, never a
  process-wide default; the dtype field is the bare name (``"float32"``),
  so on the CPU a key is letter for letter the JAX package's.
* **The exact winner is machine-scoped too**: a winner among CUDA kernels
  and plain loops timed on one card says nothing of another.
* **No launch-parameter sweep**: ``ops.geometry`` and ``ops.choose_T``
  fix the kernels' launch parameters from the shape, so a swept
  ``LaunchConfig`` would be a knob that nothing sets.
* **A measured point that fails raises.**  The JAX frontiers skip a point
  that fails to run (``except Exception: continue``).  Here a point the
  engine cannot serve is filtered out *before* it runs, by the JAX code's
  own preconditions (a coarsened point on a ragged key, a subsample of
  fewer than 2 points; :func:`scheme_points`), and any other error
  propagates: on the card a kernel that fails to build or launch fails the
  tuning call instead of quietly shrinking the frontier.

Environment variables:

``REPRO_DISABLE_AUTOTUNE=1``
    Disables the cache: lookups return ``None`` (so ``"auto"`` takes the
    static rule) and ``tune`` still measures when called but does not
    persist.
``REPRO_AUTOTUNE_CACHE=/path/to/cache.json``
    Overrides the cache location (default
    ``~/.cache/repro_torch/autotune.json``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.transforms import bucket_length

from . import timer

#: the cache file's schema tag: a string, which the JAX package's integer
#: schemas never equal (either package reads the other's file as cold)
SCHEMA = "repro_torch.autotune/1"

ENV_DISABLE = "REPRO_DISABLE_AUTOTUNE"
ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
_DEFAULT_CACHE = os.path.join("~", ".cache", "repro_torch", "autotune.json")

#: batch size tuning runners use for ops whose key shape carries no batch dim
_TUNE_BATCH = 8


def enabled() -> bool:
    """Autotuning is on unless REPRO_DISABLE_AUTOTUNE is truthy."""
    return os.environ.get(ENV_DISABLE, "").strip().lower() not in (
        "1", "true", "yes", "on")


def cache_path() -> str:
    return os.path.expanduser(os.environ.get(ENV_CACHE) or _DEFAULT_CACHE)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def bucket(shape) -> Tuple[int, ...]:
    """Round every dimension up to the next power of two (min 1)."""
    return tuple(1 if s <= 1 else 1 << (int(s) - 1).bit_length()
                 for s in shape)


#: how many leading dims of each op's key shape are batch/length-like and
#: safe to bucket to powers of two; the trailing ones (channel count d,
#: truncation depth) stay exact: cost is exponential in depth
_BUCKETED_DIMS = {"signature": 1, "logsignature": 1, "sigkernel": 2,
                  "gram": 4}


def key_shape(op: str, shape) -> Tuple[int, ...]:
    """Canonical (bucketed) key shape for ``op``; tuning measures this.

    The per-op meaning of ``shape`` (what the dispatch call sites pass):

    * ``signature`` / ``logsignature``: ``(L, d, depth)`` — increments per
      path, *transformed* channel count, truncation level;
    * ``sigkernel``: ``(nx, ny, d)`` — the *refined* PDE grid
      ``(Lx<<lam1, Ly<<lam2)`` and transformed channel count;
    * ``gram``: ``(Bx, By, nx, ny, d)``.
    """
    if op not in dispatch.OPS:
        raise ValueError(f"unknown op {op!r}; known: {dispatch.OPS}")
    n = _BUCKETED_DIMS[op]
    return bucket(shape[:n]) + tuple(int(s) for s in shape[n:])


def dtype_name(dtype) -> str:
    """The bare dtype name of a torch dtype, numpy dtype or string
    (``torch.float32`` -> ``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)          # "bfloat16": not a numpy dtype


def _device_type(device) -> str:
    return torch.device(device).type


def cache_key(op: str, shape, dtype="float32", *, device="cuda",
              ragged: bool = False, approx: bool = False,
              scheme: bool = False) -> str:
    """``op|device type|dtype|b1xb2x...[|ragged][|approx|scheme]`` on-disk key.

    ``ragged=True`` (``lengths=`` workloads) keys the masked workload apart
    from the dense one of the same padded shape; ``approx=True`` the
    feature-map frontier (:func:`tune_frontier`); ``scheme=True`` the
    discretisation frontier (:func:`tune_scheme_frontier`).  ``approx`` and
    ``scheme`` are mutually exclusive.
    """
    if approx and scheme:
        raise ValueError("cache_key: approx and scheme are separate "
                         "frontiers — pass at most one")
    dims = "x".join(str(s) for s in key_shape(op, shape))
    key = f"{op}|{_device_type(device)}|{dtype_name(dtype)}|{dims}"
    if ragged:
        key += "|ragged"
    if approx:
        key += "|approx"
    if scheme:
        key += "|scheme"
    return key


# ---------------------------------------------------------------------------
# cache I/O (memoised by mtime; fail-open on anything unexpected)
# ---------------------------------------------------------------------------

_memo: Dict[str, Tuple[Optional[float], Dict]] = {}
_machines: Dict[str, str] = {}


def invalidate_memo() -> None:
    """Drop the in-process cache-file memo (tests, post-write refresh)."""
    _memo.clear()


def _machine(device) -> str:
    """:func:`timer.machine_key` of ``device``'s type, once per process."""
    kind = _device_type(device)
    if kind not in _machines:
        _machines[kind] = timer.machine_key(kind)
    return _machines[kind]


def _entries(path: str) -> Dict[str, dict]:
    """Entries dict from ``path``; {} for missing/corrupt/foreign-schema."""
    try:
        mtime: Optional[float] = os.stat(path).st_mtime
    except OSError:
        mtime = None
    hit = _memo.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    entries: Dict[str, dict] = {}
    if mtime is not None:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if (isinstance(doc, dict) and doc.get("schema") == SCHEMA
                    and isinstance(doc.get("entries"), dict)):
                entries = doc["entries"]
        except (OSError, ValueError):
            entries = {}
    _memo[path] = (mtime, entries)
    return entries


def _store(key: str, entry: dict) -> None:
    """Write ``entry`` under ``key`` atomically (a temporary file, then
    ``os.replace``)."""
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    entries = dict(_entries(path))
    entries[key] = entry
    doc = {"schema": SCHEMA, "entries": entries}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".autotune-")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    invalidate_memo()


def cache_entry(op: str, shape, dtype="float32", *, device="cuda",
                ragged: bool = False, approx: bool = False,
                scheme: bool = False) -> Optional[dict]:
    """Full cached record or None (cold / disabled).  ``approx=True`` reads
    the feature-map frontier entry, ``scheme=True`` the discretisation
    frontier, instead of the exact winner's."""
    if not enabled():
        return None
    entry = _entries(cache_path()).get(
        cache_key(op, shape, dtype, device=device, ragged=ragged,
                  approx=approx, scheme=scheme))
    return entry if isinstance(entry, dict) else None


def _local(entry: Optional[dict], device) -> Optional[dict]:
    """``entry`` unless its ``"machine"`` stamp names another machine.
    Entries without a stamp are accepted: only a hand-written cache has
    none, and rejecting them would make the stamp impossible to test."""
    if entry is None:
        return None
    stamp = entry.get("machine")
    if isinstance(stamp, str) and stamp != _machine(device):
        return None
    return entry


def lookup(op: str, shape, dtype="float32", *, device="cuda",
           ragged: bool = False) -> Optional[str]:
    """Cached winning backend name for this key, or None (cold, disabled,
    or tuned on another machine).

    Never runs a measurement.  The caller (``dispatch.resolve``) validates
    the name against the live registry and the device, so stale entries
    degrade to the static rule rather than erroring.
    """
    entry = _local(cache_entry(op, shape, dtype, device=device, ragged=ragged),
                   device)
    if entry is None:
        return None
    name = entry.get("backend")
    return name if isinstance(name, str) else None


# ---------------------------------------------------------------------------
# tuning
# ---------------------------------------------------------------------------

def candidates(op: str, device="cuda") -> Tuple[str, ...]:
    """Exact backends worth measuring for ``op`` on ``device``: the CUDA
    kernels only for card tensors (the JAX package drops its TPU-only ones
    off the TPU).  Approximate backends compete on :func:`tune_frontier`."""
    exact = tuple(n for n in dispatch.backends_for(op)
                  if not dispatch.get(n).approximate)
    if _device_type(device) != "cuda":
        exact = tuple(n for n in exact if not dispatch.get(n).needs_cuda)
    return exact


def _ragged_lengths(batch: int, points: int, device) -> torch.Tensor:
    """Deterministic length spread for ragged tuning runs: [~P/2, P]."""
    lo = max(2, points // 2)
    return torch.as_tensor(np.linspace(lo, points, batch).round().astype("int32"),
                           device=device)


def _ragged_points(n: int) -> int:
    """Point count for a ragged runner whose key's length dim is ``n``: the
    key is taken after ``pad_ragged``'s bucketing, so the runner builds
    ``bucket_length(n)`` points (a no-op re-pad), not ``n + 1`` (which would
    re-bucket to ~2n)."""
    return bucket_length(n)


def _paths(seed: int, shape, scale: float, dtype, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.randn(shape, generator=g, device=device) * scale
    return out.to(getattr(torch, dtype_name(dtype)))


def _pair_data(shape, dtype, ragged: bool, device, batch=None):
    """Deterministic inputs at the bucketed key shape ``(nx, ny, d)`` with
    ``batch`` paths a side, or ``(Bx, By, nx, ny, d)``: X, Y and their
    lengths (None unless ragged)."""
    if batch is None:
        Bx, By, nx, ny, d = shape
    else:
        (nx, ny, d), Bx, By = shape, batch, batch
    px = _ragged_points(nx) if ragged else nx + 1
    py = _ragged_points(ny) if ragged else ny + 1
    X = _paths(0, (Bx, px, d), 0.1, dtype, device)
    Y = _paths(1, (By, py, d), 0.1, dtype, device)
    lx = _ragged_lengths(Bx, px, device) if ragged else None
    ly = _ragged_lengths(By, py, device) if ragged else None
    return X, Y, lx, ly


def _runner(op: str, shape, dtype, backend: str, ragged: bool, device):
    """Zero-arg callable exercising ``op`` at the bucketed ``shape`` on
    ``device`` through ``backend``; with ``ragged=True`` it passes a
    half- to full-length ``lengths=`` spread."""
    from repro_torch.core.gram import sigkernel_gram
    from repro_torch.core.logsignature import logsignature
    from repro_torch.core.sigkernel import sigkernel
    from repro_torch.core.signature import signature

    if op in ("signature", "logsignature"):
        L, d, depth = shape
        pts = _ragged_points(max(L, 2)) if ragged else max(L, 2) + 1
        path = _paths(0, (_TUNE_BATCH, pts, d), 0.2, dtype, device)
        lens = _ragged_lengths(_TUNE_BATCH, pts, device) if ragged else None
        fn = signature if op == "signature" else logsignature
        return lambda: fn(path, depth, backend=backend, lengths=lens)
    if op == "sigkernel":
        x, y, lx, ly = _pair_data(shape, dtype, ragged, device, batch=_TUNE_BATCH)
        return lambda: sigkernel(x, y, backend=backend, lengths_x=lx, lengths_y=ly)
    if op == "gram":
        X, Y, lx, ly = _pair_data(shape, dtype, ragged, device)
        return lambda: sigkernel_gram(X, Y, backend=backend, symmetric=False,
                                      lengths=lx, lengths_y=ly)
    raise ValueError(f"no tuning runner for op {op!r}")


def measure(op: str, shape, dtype="float32", *, device="cuda", repeats: int = 3,
            warmup: int = 1, ragged: bool = False) -> Dict[str, float]:
    """Steady-state seconds per call for every candidate backend.  A backend
    that fails raises: nothing is skipped."""
    shape = key_shape(op, shape)
    return {b: timer.bench(_runner(op, shape, dtype, b, ragged, device),
                           repeats=repeats, warmup=warmup)
            for b in candidates(op, device)}


def tune(op: str, shape, dtype="float32", *, device="cuda", repeats: int = 3,
         warmup: int = 1, force: bool = False, ragged: bool = False) -> str:
    """Measure the candidates, persist the winner, return its name.

    A warm key returns the stored winner with **zero** timed runs unless
    ``force=True``.  With autotuning disabled the measurement still
    happens (this is an explicit call) but nothing is persisted.  The
    entry is stamped with :func:`repro_torch.bench.timer.machine_key`.
    """
    if not force:
        cached = lookup(op, shape, dtype, device=device, ragged=ragged)
        if cached is not None and cached in candidates(op, device):
            return cached
    times = measure(op, shape, dtype, device=device, repeats=repeats,
                    warmup=warmup, ragged=ragged)
    winner = min(times, key=times.get)
    if enabled():
        _store(cache_key(op, shape, dtype, device=device, ragged=ragged), {
            "backend": winner,
            "timings": times,
            "machine": _machine(device),
            "tuned_at": time.time(),
            "repeats": repeats,
        })
    return winner


# ---------------------------------------------------------------------------
# accuracy-vs-speed frontier (approximate feature-map backends)
# ---------------------------------------------------------------------------

#: default rank sweep: the RFF error shrinks like 1/sqrt(rank), so a few
#: octaves cover the useful budget range
_FRONTIER_RANKS = (8, 32, 128)


def _frontier_data(shape, dtype, ragged: bool, device):
    """Deterministic Gram inputs at the bucketed key shape (cf. _runner)."""
    return _pair_data(shape, dtype, ragged, device)


def _warm_entry(key: str, field: str) -> Optional[dict]:
    entry = _entries(cache_path()).get(key)
    if isinstance(entry, dict) and isinstance(entry.get(field), list):
        return entry
    return None


def _exact_reference(shape, dtype, ragged, device, X, Y, lx, ly, repeats, warmup):
    """(backend, seconds, Gram, Frobenius norm) of the exact engine ``"auto"``
    resolves to at this key: the bar every frontier point must beat."""
    from repro_torch.core.gram import sigkernel_gram
    backend = dispatch.resolve("auto", op="gram", device=device, shape=shape,
                               dtype=dtype, ragged=ragged)

    def f_exact():
        return sigkernel_gram(X, Y, backend=backend, symmetric=False, lengths=lx,
                              lengths_y=ly)

    seconds = timer.bench(f_exact, repeats=repeats, warmup=warmup)
    K = f_exact()
    return backend, seconds, K, max(float(torch.linalg.norm(K)), 1e-30)


def tune_frontier(op: str, shape, dtype="float32", *, device="cuda",
                  ranks=_FRONTIER_RANKS, repeats: int = 3, warmup: int = 1,
                  ragged: bool = False, force: bool = False) -> dict:
    """Measure the method × rank accuracy-vs-speed frontier; persist it.

    ``op`` must be ``"gram"``.  For every approximate backend and every rank
    this measures seconds per call and the relative Frobenius error against
    the exact engine's Gram at the bucketed key shape, plus the exact
    engine's own seconds (the bar every point must beat).  Stored under the
    ``approx=True`` key, machine-stamped.  A warm key returns the stored
    entry with zero measurements unless ``force=True``; with autotuning
    disabled nothing is persisted.  A point that fails raises.
    """
    from repro_torch.core import features as ft
    from repro_torch.core.gram import sigkernel_gram
    if op != "gram":
        raise ValueError(
            f"frontier tuning only supports op='gram' (got {op!r}): the "
            "feature maps approximate Gram inner products only")
    shape = key_shape(op, shape)
    key = cache_key(op, shape, dtype, device=device, ragged=ragged, approx=True)
    if not force:
        warm = _warm_entry(key, "frontier")
        if warm is not None:
            return warm
    X, Y, lx, ly = _frontier_data(shape, dtype, ragged, device)
    exact_backend, exact_seconds, K, k_norm = _exact_reference(
        shape, dtype, ragged, device, X, Y, lx, ly, repeats, warmup)
    methods = tuple(n for n in dispatch.backends_for("gram")
                    if dispatch.get(n).approximate)
    points = []
    for method in methods:
        for rank in ranks:
            feats = ft.FeatureConfig(method=method, rank=int(rank))

            def f(fc=feats):
                return sigkernel_gram(X, Y, features=fc, symmetric=False,
                                      lengths=lx, lengths_y=ly)

            Ka = f()
            secs = timer.bench(f, repeats=repeats, warmup=0)
            rel = float(torch.linalg.norm(Ka - K)) / k_norm
            points.append({"backend": method, "rank": int(rank),
                           "rel_err": rel, "seconds": secs})
    entry = {
        "frontier": points,
        "exact_backend": exact_backend,
        "exact_seconds": exact_seconds,
        "machine": _machine(device),
        "tuned_at": time.time(),
        "repeats": repeats,
    }
    if enabled():
        _store(key, entry)
    return entry


def _budget_points(entry: Optional[dict], field: str, device):
    """(points, exact seconds) of a local frontier entry, or None."""
    entry = _local(entry, device)
    if entry is None:
        return None
    points = entry.get(field)
    exact_s = entry.get("exact_seconds")
    if not isinstance(points, list) or not isinstance(exact_s, (int, float)):
        return None
    return [p for p in points if isinstance(p, dict)], float(exact_s)


def lookup_budget(op: str, shape, dtype="float32", error_budget=None, *,
                  device="cuda", ragged: bool = False) -> Optional[Tuple[str, int]]:
    """Cheapest measured frontier point fitting ``error_budget``, or None.

    Never measures.  Returns ``(backend_name, rank)`` for the fastest point
    whose relative error is ``<= error_budget`` *and* whose seconds beat
    the exact engine's.  None on a cold or disabled cache, a malformed
    entry, no qualifying point, or a foreign ``"machine"`` stamp.
    """
    if error_budget is None:
        return None
    budget = float(error_budget)
    found = _budget_points(cache_entry(op, shape, dtype, device=device, ragged=ragged,
                                       approx=True), "frontier", device)
    if found is None:
        return None
    points, exact_s = found
    best = None
    for p in points:
        try:
            name = str(p["backend"])
            rank = int(p["rank"])
            rel = float(p["rel_err"])
            secs = float(p["seconds"])
        except (KeyError, TypeError, ValueError):
            continue
        if rel <= budget and secs <= exact_s and (
                best is None or secs < best[2]):
            best = (name, rank, secs)
    return None if best is None else (best[0], best[1])


# ---------------------------------------------------------------------------
# discretisation frontier (scheme × grid coarseness × interior precision)
# ---------------------------------------------------------------------------

#: every non-default discretisation point the scheme frontier measures:
#: (scheme, coarsen, interior_dtype).  ``coarsen=1`` halves the PDE grid (a
#: stride-2 path subsample at the default refinement); the identity point
#: (order1, 0, float32) is the baseline and is never listed
_SCHEME_POINTS = tuple(
    (s, c, dt)
    for s in ("order1", "order2") for c in (0, 1)
    for dt in ("float32", "bfloat16")
    if (s, c, dt) != ("order1", 0, "float32"))


def scheme_points(shape, *, ragged: bool = False, points=_SCHEME_POINTS) -> tuple:
    """The points of ``points`` the engine can serve at the bucketed gram key
    ``shape``, by the JAX package's preconditions: no coarsened point on a
    ragged key (masked batches cannot be stride-subsampled), and no
    subsample of fewer than 2 points.  :func:`tune_scheme_frontier`
    measures exactly these; nothing is skipped after it runs."""
    Bx, By, nx, ny, d = key_shape("gram", shape)
    px = _ragged_points(nx) if ragged else nx + 1
    py = _ragged_points(ny) if ragged else ny + 1
    out = []
    for sch, coarsen, idt in points:
        if ragged and coarsen:
            continue
        step = 1 << int(coarsen)
        if -(-px // step) < 2 or -(-py // step) < 2:
            continue
        out.append((sch, int(coarsen), idt))
    return tuple(out)


def tune_scheme_frontier(op: str, shape, dtype="float32", *, device="cuda",
                         points=_SCHEME_POINTS, repeats: int = 3,
                         warmup: int = 1, ragged: bool = False,
                         force: bool = False) -> dict:
    """Measure the (scheme, coarsen, interior_dtype) frontier; persist it.

    The exact-engine sibling of :func:`tune_frontier`: every point solves
    the Goursat PDE with another discretisation, on the exact engine's
    backend.  For each of :func:`scheme_points` it measures seconds per
    call and the relative Frobenius error against the order-1 fine-grid f32
    Gram at the bucketed key shape, plus that baseline's seconds.
    ``coarsen=c`` is applied as the engine replays it at the default
    refinement: a stride-``2^c`` path subsample.  Stored under the
    ``scheme=True`` key, machine-stamped; warm keys return the stored
    entry unless ``force=True``.  A point that fails raises.
    """
    from repro_torch.core.config import GridConfig
    from repro_torch.core.gram import sigkernel_gram
    if op != "gram":
        raise ValueError(
            f"scheme-frontier tuning only supports op='gram' (got {op!r}): "
            "the budgeted discretisation swap lives in the Gram engine")
    shape = key_shape(op, shape)
    key = cache_key(op, shape, dtype, device=device, ragged=ragged, scheme=True)
    if not force:
        warm = _warm_entry(key, "scheme_frontier")
        if warm is not None:
            return warm
    X, Y, lx, ly = _frontier_data(shape, dtype, ragged, device)
    exact_backend, exact_seconds, K, k_norm = _exact_reference(
        shape, dtype, ragged, device, X, Y, lx, ly, repeats, warmup)
    measured = []
    for sch, coarsen, idt in scheme_points(shape, ragged=ragged, points=points):
        step = 1 << coarsen
        Xc, Yc = X[:, ::step], Y[:, ::step]
        g = GridConfig(scheme=sch, interior_dtype=idt)

        def f(gc=g, a=Xc, b=Yc):
            return sigkernel_gram(a, b, backend=exact_backend, symmetric=False,
                                  grid=gc, lengths=lx, lengths_y=ly)

        Ka = f()
        secs = timer.bench(f, repeats=repeats, warmup=0)
        rel = float(torch.linalg.norm(Ka - K)) / k_norm
        measured.append({"scheme": sch, "coarsen": coarsen,
                         "interior_dtype": idt, "rel_err": rel,
                         "seconds": secs})
    entry = {
        "scheme_frontier": measured,
        "exact_backend": exact_backend,
        "exact_seconds": exact_seconds,
        "machine": _machine(device),
        "tuned_at": time.time(),
        "repeats": repeats,
    }
    if enabled():
        _store(key, entry)
    return entry


def lookup_scheme_budget(op: str, shape, dtype="float32", error_budget=None, *,
                         device="cuda", ragged: bool = False
                         ) -> Optional[Tuple[str, int, str]]:
    """Cheapest measured discretisation fitting ``error_budget``, or None.

    Never measures.  Returns ``(scheme, coarsen, interior_dtype)`` for the
    fastest :func:`tune_scheme_frontier` point whose relative error is
    ``<= error_budget`` *and* whose seconds beat the order-1 fine-grid f32
    baseline's; None on everything else, a foreign ``"machine"`` stamp
    included.
    """
    if error_budget is None:
        return None
    budget = float(error_budget)
    found = _budget_points(cache_entry(op, shape, dtype, device=device, ragged=ragged,
                                       scheme=True), "scheme_frontier", device)
    if found is None:
        return None
    points, exact_s = found
    best = None
    for p in points:
        try:
            sch = str(p["scheme"])
            coarsen = int(p["coarsen"])
            idt = str(p["interior_dtype"])
            rel = float(p["rel_err"])
            secs = float(p["seconds"])
        except (KeyError, TypeError, ValueError):
            continue
        if rel <= budget and secs <= exact_s and (
                best is None or secs < best[3]):
            best = (sch, coarsen, idt, secs)
    return None if best is None else (best[0], best[1], best[2])
