"""Run the benchmark workloads and emit a schema-versioned BENCH JSON.

The JSON document (schema 1, the JAX package's):

``{"schema": 1, "mode": "smoke" | "quick" | "full", "repeats": int,
   "created_unix": float, "wall_seconds": float,
   "fingerprint": {...},  # timer.fingerprint(): the card's name, power limit
   "launches": {workload: {kernel launcher: launches}},  # this process's
   "entries": [ ... ]}    # workloads entry dicts, each with its roofline

``python -m repro_torch.bench --full`` on the card writes
``BENCH_TORCH_full.json``; :mod:`repro_torch.bench.compare` gates one such
document against another.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.kernels.sigkernel_pde import kernel as pde_kernel
from repro_torch.kernels.signature import kernel as sig_kernel

from . import roofline, timer, workloads

SCHEMA = 1

#: workloads per mode, in run order (smoke adds the correctness checks and
#: the autotune round trip on top of scaled-down paper tables), at the JAX
#: package's positions.  The autotune workloads write the cache at
#: ``REPRO_AUTOTUNE_CACHE``.
WORKLOAD_SETS: Dict[str, Tuple[Callable, ...]] = {
    "smoke": (workloads.calibration, workloads.smoke_checks,
              workloads.autotune_auto, workloads.table1_signatures,
              workloads.table2_sigkernels, workloads.rbf_lift,
              workloads.ragged_gram, workloads.distributed_gram,
              workloads.approx_frontier, workloads.scheme_frontier,
              workloads.path_update,
              workloads.table3_logsignatures, workloads.grad_accuracy),
    "quick": (workloads.calibration, workloads.table1_signatures,
              workloads.table2_sigkernels, workloads.rbf_lift,
              workloads.ragged_gram, workloads.distributed_gram,
              workloads.approx_frontier, workloads.scheme_frontier,
              workloads.path_update,
              workloads.table3_logsignatures,
              workloads.fig1_truncation_sweep, workloads.fig2_length_sweep,
              workloads.grad_accuracy),
    "full": (workloads.calibration, workloads.table1_signatures,
             workloads.table2_sigkernels, workloads.rbf_lift,
             workloads.ragged_gram, workloads.distributed_gram,
             workloads.approx_frontier, workloads.scheme_frontier,
             workloads.path_update,
             workloads.table3_logsignatures,
             workloads.fig1_truncation_sweep, workloads.fig2_length_sweep,
             workloads.grad_accuracy),
}

_DEFAULT_REPEATS = {"smoke": 2, "quick": 3, "full": 5}


def check_device(device) -> torch.device:
    """The run's device; the card is refused where CUDA is not available
    (no quiet fallback to the CPU)."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card by default and CUDA is not "
                           "available here; pass device='cpu' (--device cpu) to run "
                           "the plain versions on the CPU")
    return device


def _launch_counts() -> Dict[str, int]:
    return {**pde_kernel.launch_counts(), **sig_kernel.launch_counts()}


def run_suite(mode: str = "quick", repeats: int = None,
              progress: Callable[[str], None] = None, device="cuda") -> dict:
    """Run every workload for ``mode`` on ``device`` and return the BENCH
    document."""
    if mode not in WORKLOAD_SETS:
        raise ValueError(
            f"mode must be one of {sorted(WORKLOAD_SETS)}, got {mode!r}")
    device = check_device(device)
    if repeats is None:
        repeats = _DEFAULT_REPEATS[mode]
    t0 = time.perf_counter()
    entries: List[dict] = []
    launches: Dict[str, Dict[str, int]] = {}
    for fn in WORKLOAD_SETS[mode]:
        if progress is not None:
            progress(f"running {fn.__name__} ...")
        before = _launch_counts()
        entries.extend(fn(mode, repeats, device=device))
        ran = {k: n - before[k] for k, n in _launch_counts().items() if n > before[k]}
        if ran:
            launches[fn.__name__] = ran
        if device.type == "cuda":
            # the largest cells' memory stays cached otherwise
            torch.cuda.empty_cache()
    names = [e["name"] for e in entries]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:  # names are the compare join key; duplicates poison the gate
        raise RuntimeError(f"duplicate benchmark entry names: {sorted(dupes)}")
    planned = workloads.plan(mode, device)
    got = [(e["name"], e["kind"], e["meta"]) for e in entries]
    if got != planned:
        raise RuntimeError("the run's entries differ from workloads.plan: "
                           f"{[g for g in got if g not in planned][:5]} / "
                           f"{[p for p in planned if p not in got][:5]}")
    for e in entries:
        roofline.attach(e, device)
    return {
        "schema": SCHEMA,
        "mode": mode,
        "repeats": repeats,
        "created_unix": time.time(),
        "wall_seconds": time.perf_counter() - t0,
        "fingerprint": timer.fingerprint(device),
        "launches": launches,
        "entries": entries,
    }


def write_json(doc: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: not a schema-{SCHEMA} BENCH JSON "
            f"(schema={doc.get('schema') if isinstance(doc, dict) else '?'})")
    return doc


def markdown_summary(doc: dict) -> str:
    """Human-readable summary of one BENCH document."""
    fp = doc.get("fingerprint", {})
    head = [
        f"## bench — mode `{doc.get('mode')}`, repeats {doc.get('repeats')}",
        "",
        f"platform `{fp.get('platform')}` ({fp.get('device_kind')}, power limit "
        f"{fp.get('power_limit')}), torch {fp.get('torch')}, CUDA {fp.get('cuda')}, "
        f"python {fp.get('python')}, {fp.get('cpu_count')} cpus",
        "",
        f"launches by workload: {doc.get('launches')}",
        "",
        "| entry | µs/call | value | notes |",
        "|---|---:|---:|---|",
    ]
    rows = []
    for e in doc["entries"]:
        us = f"{e['seconds'] * 1e6:.1f}" if e["kind"] == "time" else ""
        val = f"{e['value']:.2e}" if e["kind"] == "accuracy" else ""
        rows.append(f"| {e['name']} | {us} | {val} | {e.get('derived', '')} |")
    return "\n".join(head + rows)
