"""The cells at a size a CPU test can hold: every shape cut to a few short
paths, the sharded cell to two gloo ranks."""

from __future__ import annotations

import time

from sigbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def cell(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    ranks = min(int(c.config.get("ranks", 1)), 2)
    c.config = dict(c.config, x_shape=[6, 20, 3], y_shape=[6, 18, 3], ranks=ranks)
    return c


def run(name: str, *, trace: bool = False, fault=None, seed: int = 2 ** 31 + 11,
        seconds: float = 0.3) -> dict:
    return harness.run(cell(name), seed, seconds, trace, time.time(), dev_type="cpu",
                       fault=fault)
