"""One run of one cell: set-up, the measured window, the trace, the check.

:func:`run` is what ``run.py`` calls once it has found the cards.  A cell
on one card runs in this process; a cell on several starts one process a
card through the port's ``spawn_ranks`` (NCCL; its rendezvous file lies
under ``TMPDIR``), every rank makes the same calls, and rank 0 times them,
traces them and checks them.

The window is a closed loop with one caller.  A call starts on the host
clock, returns, and ends when the card's stream has finished it; the next
starts after the harness has noted it.  Calls cycle through the pool of
batches drawn at set-up.  The call is the entry's that the traffic names
(``entries/<entry>.py``), which also gives its reference and its counts.  A call that raises, or whose value or gradient is
not finite, counts in ``failed``.  A sample of the calls, drawn from the
seed, keeps its outputs, which the plain reference judges once the window
has closed and its memory has been read.

A traced run traces the second half of its window only: the per-layer
metrics of the host (``host_dispatch_ms``) read the calls of the first
half, which the profiler's per-operation cost on the host does not touch,
and the device's metrics read the traced calls.  The profiler's first start
in a process loads and sets up the device's tracing library, which takes
seconds: set-up starts and stops it once around a warm-up call, and the
traced half lasts ``seconds / 2`` from the profiler's start in the window.  Each rank of a cell on
several cards reports the modules it holds once its window has closed, so
that ``run.py`` can refuse a run in which any rank loaded JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import random
import sys
import time
import types
from typing import Optional

import torch

from . import check, counts, device, entries, inputs, trace as tracing
from .spec import Cell

#: what rank 0 tells every rank after each call
GO, TRACE, STOP = 0.0, 1.0, 2.0


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    calls: list                 # (start, returned, end) of each call, seconds
    setup_s: float
    peak_window_bytes: int
    attempted: int
    failed: int
    counts: dict                # one call's work on this rank (the entry's counts)
    peaks: Optional[dict]       # the card's published peaks (counts/peaks.json)
    trace: Optional[tracing.Trace] = None
    traced_from: Optional[int] = None   # the first traced call, in a traced run

    @property
    def window_s(self) -> float:
        return self.calls[-1][2] - self.calls[0][0] if self.calls else 0.0

    @property
    def untraced_calls(self) -> list:
        """The calls that ran without the profiler: all of them in an
        untraced run, the first half of the window's in a traced one."""
        return self.calls if self.traced_from is None else self.calls[:self.traced_from]

    @property
    def traced_calls(self) -> list:
        """The calls inside the trace (none in an untraced run)."""
        return [] if self.traced_from is None else self.calls[self.traced_from:]


def _fault(spec: Optional[str]):
    """The context manager ``module:function`` names (a broken timed path,
    for the benchmark's own tests), or none.  ``"control"`` is no context
    manager: the entry's control replaces its call."""
    if not spec or spec == "control":
        return contextlib.nullcontext()
    mod, fn = spec.split(":")
    return getattr(importlib.import_module(mod), fn)()


def _span(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _finite(value: torch.Tensor, g) -> torch.Tensor:
    """Whether a call's value and gradient are finite, as a flag on the card
    (read once the window has closed)."""
    ok = torch.isfinite(value).all()
    return ok if g is None else ok & torch.isfinite(g).all()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def check_config(entry, cfg: dict) -> None:
    """Refuse a configuration whose settings the entry and its reference do
    not both follow (the entry's ``SETTINGS``)."""
    for key, allowed in entry.SETTINGS.items():
        if cfg.get(key) not in allowed:
            raise ValueError(f"the entry follows {key} in {allowed!r}, the config states "
                             f"{cfg.get(key)!r}")


def _profile(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, dev: torch.device,
            t0: float, *, rank: int = 0, world: int = 1, mesh=None,
            fault: Optional[str] = None) -> dict:
    """Set up, warm up, run the window and, on rank 0, check it.  Returns
    what :func:`run` prints: the run's metrics, counts and check."""
    import repro_torch as rt
    cfg, traffic = cell.config, cell.traffic
    entry = entries.load(traffic["entry"])
    check_config(entry, cfg)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    grad = bool(traffic["grad"])
    ctx = types.SimpleNamespace(config=cfg, traffic=traffic, kwargs=traffic.get("kwargs", {}),
                                grad=grad, mesh=mesh, seed=seed)
    if hasattr(entry, "prepare"):
        entry.prepare(rt, ctx)
    call = entry.control if fault == "control" else entry.call
    batches = inputs.pool(seed, cfg, traffic, dev)
    for b in batches:
        b["x"].requires_grad_(grad)
    lead = rank == 0
    calls, flags, sample = [], [], []
    failed = 0
    rng = random.Random(seed)
    keep = int(cell.workload["sample"])
    state = torch.zeros(1, device=dev)
    prof = window = None
    traced_from = t_trace = None
    profiler_start_s = None
    with _fault(fault), torch.set_grad_enabled(grad):
        for i in range(int(traffic["warmup_calls"])):
            _finite(*call(rt, batches[i % len(batches)], ctx))
            if world > 1:
                torch.distributed.broadcast(state, 0)
        if trace:                       # the tracing library's start-up, out of the window
            with _profile(dev):
                _finite(*call(rt, batches[0], ctx))
                _sync(dev)
        _sync(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.time() - t0
        w0 = time.perf_counter()
        i = 0
        while True:
            b = i % len(batches)
            on = prof is not None
            start = time.perf_counter()
            try:
                with _span(on, "sigbench.call"):
                    value, g = call(rt, batches[b], ctx)
                returned = time.perf_counter()
                with _span(on, "sigbench.sync"):
                    _sync(dev)
                end = time.perf_counter()
            except Exception as exc:   # a failed call counts and the loop goes on
                print(f"call {i} failed: {exc!r}", file=sys.stderr)
                failed += 1
                value = None
            with _span(on, "sigbench.between"):
                if value is not None:
                    calls.append((start, returned, end))
                    flags.append(_finite(value, g))
                    n = len(calls) - 1      # reservoir sampling from the seed
                    if n < keep:
                        sample.append((b, value, g))
                    else:
                        slot = rng.randint(0, n)
                        if slot < keep:
                            sample[slot] = (b, value, g)
                i += 1
                now = time.perf_counter()
                if trace and not on:
                    step = TRACE if now - w0 >= seconds / 2 else GO
                elif trace:
                    step = STOP if now - t_trace >= seconds / 2 else GO
                else:
                    step = STOP if now - w0 >= seconds else GO
                if world > 1:           # rank 0's clock steers every rank's loop
                    state.fill_(step)
                    torch.distributed.broadcast(state, 0)
                    step = float(state.item())
            if step == STOP:
                break
            if step == TRACE:
                p0 = time.perf_counter()
                prof = _profile(dev)
                prof.__enter__()
                window = torch.profiler.record_function(tracing.WINDOW)
                window.__enter__()
                traced_from = len(calls)
                t_trace = time.perf_counter()
                profiler_start_s = t_trace - p0
        if window is not None:
            window.__exit__(None, None, None)
        _sync(dev)
        if prof is not None:
            prof.__exit__(None, None, None)
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finite = torch.stack(flags).cpu() if flags else torch.ones(0, dtype=torch.bool)
    failed += int((~finite).sum())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    share = {k: v / world if k.endswith(("flops", "bytes")) else v
             for k, v in entry.counts(cfg, traffic).items()}
    tr = tracing.summarize(prof, dev.index or 0) if prof is not None else None
    runrec = Run(calls=calls, setup_s=setup_s, peak_window_bytes=peak_window,
                 attempted=i, failed=failed, counts=share, peaks=counts.peaks(kind),
                 trace=tr, traced_from=traced_from)
    out = {"kind": kind, "memory_peak_bytes": max(setup_peak, peak_window),
           "busy_s": tr.busy_ns * 1e-9 if tr else None,
           "window_s": tr.window_ns * 1e-9 if tr else None}
    if not lead:
        return out
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = m.read(runrec)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    if dev.type == "cuda":   # the pool and the sample stay: the reference reads them
        torch.cuda.empty_cache()
    ref0 = time.perf_counter()
    found = judge(cell, entry, batches, sample)
    found["lines"].insert(0, f"reference_s {time.perf_counter() - ref0!r} (not compared)")
    if profiler_start_s is not None:
        found["lines"].insert(0, f"profiler_start_s {profiler_start_s!r} (not compared)")
    out.update(attempted=runrec.attempted, failed=runrec.failed, metrics=metrics,
               check=found, breakdown=(
                   {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps} if tr else None))
    return out


def judge(cell: Cell, entry, batches: list, sample: list) -> dict:
    """The entry's plain reference over the sampled calls' batches (once a
    batch), and the comparison with their outputs: ``{"correct",
    "numbers", "limits", "lines"}``."""
    refs = {}
    for b, _, _ in sample:
        if b not in refs:
            refs[b] = entry.reference(batches[b], cell.config, cell.traffic)
    found = check.numbers([(v, g) for _, v, g in sample],
                          [refs[b] for b, _, _ in sample]) if sample else {}
    limits = cell.workload["limits"]
    ok, lines = check.judge(found, limits, len(sample))
    return {"correct": ok, "numbers": found, "limits": limits, "lines": lines}


def _rank_main(rank: int, world: int, cell: Cell, seed: int, seconds: float, trace: bool,
               t0: float, fault: Optional[str]) -> dict:
    """One rank of a cell on several cards (``spawn_ranks`` calls it after
    joining the group)."""
    from repro_torch.launch import make_gram_mesh
    dev = torch.device("cuda", rank) if torch.distributed.get_backend() == "nccl" \
        else torch.device("cpu")
    if dev.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    out = measure(cell, seed, seconds, trace, dev, t0, rank=rank, world=world,
                  mesh=make_gram_mesh(), fault=fault)
    out["held"] = device.forbidden_modules()
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float, *,
        dev_type: str = "cuda", fault: Optional[str] = None) -> dict:
    """One run of ``cell``: the result line's fields, ``check``, and the
    private ``_lines`` (the compared numbers as text) and ``_held`` (the
    forbidden modules that the cell's rank processes held)."""
    world = int(cell.config.get("ranks", 1))
    if world > 1:
        from repro_torch.launch import spawn_ranks
        outs = spawn_ranks(_rank_main, world, (cell, seed, seconds, trace, t0, fault),
                           backend="nccl" if dev_type == "cuda" else "gloo")
    else:
        dev = torch.device("cuda", 0) if dev_type == "cuda" else torch.device("cpu")
        outs = [measure(cell, seed, seconds, trace, dev, t0, fault=fault)]
    lead = outs[0]
    dev_field = {"platform": "gpu" if dev_type == "cuda" else "cpu", "kind": lead["kind"],
                 "count": world,
                 "memory_peak_bytes": max(o["memory_peak_bytes"] for o in outs)}
    if trace:
        dev_field["busy_s"] = sum(o["busy_s"] for o in outs) / world
        dev_field["window_s"] = lead["window_s"]
    result = {"correct": lead["check"]["correct"], "attempted": lead["attempted"],
              "failed": lead["failed"], "metrics": lead["metrics"], "device": dev_field}
    if trace and lead["breakdown"]:
        result["breakdown"] = lead["breakdown"]
    result["check"] = {name: {"value": lead["check"]["numbers"].get(name, math.nan),
                              "limit": limit}
                       for name, limit in lead["check"]["limits"].items()}
    result["_lines"] = lead["check"]["lines"]
    result["_held"] = sorted({m for o in outs for m in o.get("held", [])})
    return result
