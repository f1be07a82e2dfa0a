"""The work a timed call needs, counted from its shapes.

The counts say what the call's inputs need, whatever implements it: each
input byte is read once, each output byte written once, and a
recomputation that an implementation chooses (the checkpointed forward
that the backward replays, Δ rebuilt in the backward) is not counted.
They stand in for ``repro_torch/bench/roofline.py``'s ``analytic_counts``,
which counts Δ's bytes three times and guesses the gradient as three
forwards.

A pair of paths with n and m increments at dyadic order λ has
``(n·2^λ)·(m·2^λ)`` refined cells.  Per refined cell, as floating-point
operations (a fused multiply-add counts 2):

* forward (pySigLib eq. (1)): q = p·p (1); A = 1 + p/2 + q/12 (two
  FMAs, 4); B = 1 - q/12 (one FMA, 2); s = left + up (1);
  k = s·A - diag·B (a product and an FMA, 3): **11**;
* adjoint sweep, from the forward's A, B and s: G = G_r·A_r + G_d·A_d
  - G_dr·B (a product and two FMAs, 5); A' = 1/2 + p/6 (one FMA, 2);
  B' = -p/6 (1); s·A' - diag·B' (a product and an FMA, 3); times G (1):
  **12**.

Outside the Goursat layer, per unrefined cell: Δ[i, j] = ⟨dx_i, dy_j⟩
is ``2d`` operations, and pulling ∂/∂Δ back to one side's increments is
``2d`` more per side that needs a gradient.  The loss's sums over the
Grams and the increments' differences are a few operations a pair or a
point, under a thousandth of the rest, and left out.

Which pairs a call solves forward, sweeps back and pulls back is the
entry's to say (``entries/<entry>.py``, ``counts``); this file turns those
pair counts into work.  No Goursat entry runs a Horner scan.
"""

from __future__ import annotations

FWD_FLOPS_PER_CELL = 11
ADJ_FLOPS_PER_CELL = 12


def tri(b: int) -> int:
    """Pairs in the upper triangle of a b × b Gram, its diagonal included."""
    return b * (b + 1) // 2


def goursat(config: dict, traffic: dict, *, fwd: int, bwd: int, pulled: int) -> dict:
    """The counts of one call that solves ``fwd`` pairs forward and, with
    the gradient, sweeps ``bwd`` pairs back and pulls ``pulled`` sides of
    them back to the increments: ``goursat_flops`` and ``goursat_bytes``
    (the Goursat layer), ``call_flops`` (the whole call), ``pair_solves``
    (what ``count_pair_solves`` records) and ``scan_steps`` (what
    ``count_scan_steps`` records), all over every rank the call runs on."""
    x_shape, y_shape = config["x_shape"], config["y_shape"]
    lam = int(config["dyadic_order"])
    grad = bool(traffic["grad"])
    n, m, d = x_shape[1] - 1, y_shape[1] - 1, x_shape[2]
    refined = (n << lam) * (m << lam)
    cells = n * m
    word = 8 if config["dtype"] == "float64" else 4
    goursat_flops = fwd * refined * FWD_FLOPS_PER_CELL
    delta_flops = fwd * cells * 2 * d
    # increments in, one value a pair out; the gradient of X's increments out
    goursat_bytes = word * ((x_shape[0] * n + y_shape[0] * m) * d + fwd)
    if grad:
        goursat_flops += bwd * refined * ADJ_FLOPS_PER_CELL
        delta_flops += pulled * cells * 2 * d
        goursat_bytes += word * x_shape[0] * n * d
    return {"goursat_flops": float(goursat_flops), "goursat_bytes": float(goursat_bytes),
            "call_flops": float(goursat_flops + delta_flops),
            "pair_solves": fwd, "scan_steps": 0}
