"""How ``correct`` is decided: the numbers that hold a run's sampled calls
against the plain reference, and their limits.

Each sampled call's value and gradient are compared with the reference's
for the same inputs, row by row: a row is one kernel value and one path's
gradient (``sigkernel``), or the loss and one path of X's gradient
(``mmd2``).  A row's gap is the size of its difference, measured against
the larger of the reference row's size and the median reference row's (a
gradient row can be all but zero):

* ``value_err``: the largest gap of a value over the sampled calls;
* ``grad_err``: the largest gap of a gradient row (cells with a gradient).

The limits sit in ``workloads/<cell>.json``; PERF.md gives the readings
each was set from.
"""

from __future__ import annotations

import math

import torch


def _worst_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog = prog.detach().to(torch.float64).reshape(ref.shape[0] if ref.dim() else 1, -1)
    ref = ref.detach().to(torch.float64).reshape(prog.shape)
    size = ref.norm(dim=1)
    gap = (prog.to(ref.device) - ref).norm(dim=1)
    scale = torch.maximum(size, size.median())
    return float((gap / scale).max())


def numbers(prog: list, ref: list) -> dict:
    """The compared numbers for pairs of ``(value, grad)`` outputs, the
    program's and the reference's for the same batches."""
    out = {"value_err": max(_worst_gap(p[0], r[0]) for p, r in zip(prog, ref))}
    if prog[0][1] is not None:
        out["grad_err"] = max(_worst_gap(p[1], r[1]) for p, r in zip(prog, ref))
    return out


def judge(found: dict, limits: dict, sampled: int) -> tuple:
    """``(correct, lines)``: correct when a call was sampled and every limit
    holds; one line a number, with its limit."""
    lines = [f"sampled_calls {sampled} limit >= 1"]
    ok = sampled >= 1
    for name, limit in limits.items():
        value = found.get(name, math.nan)
        ok = ok and math.isfinite(value) and value <= limit
        lines.append(f"{name} {value!r} limit {limit!r}")
    return ok, lines
