"""The cells' inputs, drawn on the device from the run's seed.

Table 2 of the pySigLib paper times batches of ``B`` paths of ``L``
points in ``d`` channels whose points are independent normal draws scaled
by 0.1 (``src/repro/bench/workloads.py``, ``_paths``).  The traffic files
give each side its ``scale`` and a ``drift``, a straight line from 0 to
``drift`` in every channel added to the draws, so the "generated" batch X
and the "data" batch Y can come from two distributions and the loss and its
gradient stay away from zero.

A run draws a pool of ``pool`` batches in one call a side, with one
generator on the device; every seed gives the same shapes.
"""

from __future__ import annotations

import torch


def table2_paths(generator: torch.Generator, count: int, shape, scale: float,
                 drift: float, dtype=torch.float32) -> torch.Tensor:
    """``count`` batches of paths ``shape`` = (B, L, d): N(0, scale²) points
    plus a linear drift, (count, B, L, d) on the generator's device."""
    B, L, d = shape
    dev = generator.device
    z = torch.randn((count, B, L, d), generator=generator, device=dev, dtype=dtype)
    line = torch.linspace(0.0, float(drift), L, device=dev, dtype=dtype)
    return z * scale + line[:, None]


def pool(seed: int, config: dict, traffic: dict, device) -> list:
    """The run's batches: a list of ``traffic["pool"]`` dicts ``{"x": ...,
    "y": ...}`` of shapes ``config["x_shape"]`` and ``config["y_shape"]``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = int(traffic["pool"])
    xs = table2_paths(g, n, config["x_shape"], **traffic["x"])
    ys = table2_paths(g, n, config["y_shape"], **traffic["y"])
    return [{"x": xs[i], "y": ys[i]} for i in range(n)]
