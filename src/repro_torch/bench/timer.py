"""Steady-state timing and machine fingerprinting.

``bench`` is the paper §5 methodology: warm the callable up, then take the
minimum wall time over ``repeats`` runs, each fenced by
``torch.cuda.synchronize()`` on the card so that asynchronous launches
never hide work (the port's ``block_until_ready``).  The paper takes
min-over-50; the suite defaults to far fewer — pass ``repeats=50`` for
paper-exact numbers.

``fingerprint`` records enough about the machine that a committed BENCH
JSON can be compared against a run from another box with eyes open: on the
card its name, memory and power limit (a card set below its 700 W runs
slower under load), and the torch / CUDA versions.

``machine_key`` is the compact subset launch parameters depend on
(platform, device kind, device memory).
"""

from __future__ import annotations

import os
import platform as _platform
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch


def _fence() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def bench(fn, *args, repeats: int = 5, warmup: int = 2) -> float:
    """Minimum wall time (seconds) of ``fn(*args)`` over ``repeats`` runs.

    ``warmup`` untimed calls first absorb kernel builds and allocator
    growth; every call is fenced with ``torch.cuda.synchronize()``.
    """
    for _ in range(warmup):
        fn(*args)
        _fence()
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn(*args)
        _fence()
        best = min(best, time.perf_counter() - t0)
    return best


def _host_memory_bytes() -> int:
    try:
        return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    except (ValueError, OSError, AttributeError):
        return 0


def power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` reports it ("700.00 W"),
    or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",", 1)[1].strip() if lines and "," in lines[0] else None


def _device_facts(device) -> Dict[str, object]:
    cuda = torch.device(device).type == "cuda"
    return {
        "platform": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_memory": (torch.cuda.get_device_properties(0).total_memory if cuda
                          else _host_memory_bytes()),
    }


def fingerprint(device="cuda") -> Dict[str, object]:
    """Machine/runtime identity stamped into every BENCH JSON."""
    facts = _device_facts(device)
    cuda = facts["platform"] == "cuda"
    return {
        **facts,
        "power_limit": power_limit() if cuda else None,
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "python": _platform.python_version(),
        "system": _platform.system(),
        "machine": _platform.machine(),
        "cpu_count": os.cpu_count(),
    }


def machine_key(device="cuda") -> str:
    """``platform|device_kind|device_memory`` — the part of the fingerprint
    launch parameters depend on."""
    return "|".join(str(v) for v in _device_facts(device).values())
