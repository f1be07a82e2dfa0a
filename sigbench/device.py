"""The card a run used, and what its process must not hold.

``power_limit`` is frozen from ``repro_torch/bench/timer.py``: a card set
below its 700 W runs slower under load, so every result names its limit.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Optional

#: top-level module names a run's process may not hold: JAX and the JAX
#: package, which the port's name begins with (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


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


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules) if name.split(".")[0] in FORBIDDEN)


def held(result: dict) -> list:
    """The forbidden modules that this process holds or that the rank
    processes of ``result`` (``harness.run``'s, whose private ``_held`` this
    takes out) reported."""
    return sorted(set(forbidden_modules()) | set(result.pop("_held", [])))
