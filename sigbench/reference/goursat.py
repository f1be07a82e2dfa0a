"""The Goursat scheme of the signature kernel and its exact adjoint, in
plain PyTorch: the benchmark's reference, independent of the program.

pySigLib eq. (1), dyadic order 0, on a grid of nodes k[i, j] (0 <= i <= n,
0 <= j <= m) with k = 1 on the boundary i = 0 or j = 0, and for i, j >= 1

    k[i, j] = (k[i, j-1] + k[i-1, j]) * A(p) - k[i-1, j-1] * B(p),
    p = Δ[i-1, j-1],  A(p) = 1 + p/2 + p²/12,  B(p) = 1 - p²/12.

The kernel value is k[n, m].  The adjoint of that scheme (the exact
gradient of the discrete solve, §3.4) runs the same anti-diagonals
backwards.  A node (i, j) feeds (i, j+1) through A(Δ[i-1, j]), (i+1, j)
through A(Δ[i, j-1]) and (i+1, j+1) through -B(Δ[i, j]), so with
G = ∂k[n, m]/∂k

    G[i, j] = G[i, j+1]·A(Δ[i-1, j]) + G[i+1, j]·A(Δ[i, j-1]) - G[i+1, j+1]·B(Δ[i, j])

(terms outside the grid are zero), and

    ∂k[n, m]/∂Δ[i-1, j-1] = G[i, j]·((k[i, j-1] + k[i-1, j])·A'(p) - k[i-1, j-1]·B'(p)).

Both sweeps work one anti-diagonal at a time over every pair of the batch
at once, through flat indices into the whole node grid, which the
backward keeps.  The dtype is the caller's: float64 for the reference,
float32 for the control.
"""

from __future__ import annotations

import functools

import torch


def coeff_a(p):
    return 1.0 + p / 2.0 + p * p / 12.0


def coeff_b(p):
    return 1.0 - p * p / 12.0


@functools.lru_cache(maxsize=4)
def _diagonals(n: int, m: int, device: torch.device):
    """For each anti-diagonal e = i + j of the interior nodes (i, j >= 1),
    the flat indices into an (n+2) x (m+2) grid of the node, its left, upper
    and upper-left neighbours, its right, lower and lower-right neighbours,
    and of its cell Δ[i-1, j-1] in an (n+1) x (m+1) padded Δ."""
    w = m + 2
    wd = m + 1
    out = []
    for e in range(2, n + m + 1):
        i = torch.arange(max(1, e - m), min(n, e - 1) + 1, device=device)
        j = e - i
        node = i * w + j
        out.append({
            "seed": e == n + m,
            "node": node, "left": node - 1, "up": node - w, "diag": node - w - 1,
            "right": node + 1, "down": node + w, "down_right": node + w + 1,
            "cell": (i - 1) * wd + (j - 1),          # Δ[i-1, j-1]
            "cell_up": (i - 1) * wd + j,             # Δ[i-1, j]
            "cell_left": i * wd + (j - 1),           # Δ[i, j-1]
            "cell_here": i * wd + j,                 # Δ[i, j]
        })
    return out


def solve_grid(delta: torch.Tensor):
    """All nodes k (P, n+2, m+2) of the scheme for Δ (P, n, m), flattened to
    (P, (n+2)(m+2)); the last row and column are padding (zero)."""
    P, n, m = delta.shape
    k = delta.new_zeros(P, n + 2, m + 2)
    k[:, 0, : m + 1] = 1.0
    k[:, : n + 1, 0] = 1.0
    k = k.reshape(P, -1)
    dpad = torch.nn.functional.pad(delta, (0, 1, 0, 1)).reshape(P, -1)
    for dg in _diagonals(n, m, delta.device):
        p = dpad[:, dg["cell"]]
        val = (k[:, dg["left"]] + k[:, dg["up"]]) * coeff_a(p) - k[:, dg["diag"]] * coeff_b(p)
        k[:, dg["node"]] = val
    return k


def adjoint(delta: torch.Tensor, k: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """∂/∂Δ of Σ gbar·k[n, m], given the node grid ``k`` of
    :func:`solve_grid`."""
    P, n, m = delta.shape
    w = m + 2
    g = delta.new_zeros(P, (n + 2) * w)
    g[:, n * w + m] = gbar
    dpad = torch.nn.functional.pad(delta, (0, 1, 0, 1)).reshape(P, -1)
    dd = delta.new_zeros(P, (n + 1) * (m + 1))
    for dg in reversed(_diagonals(n, m, delta.device)):
        if dg["seed"]:
            # the far corner (n, m): its neighbours lie in the padding
            gn = g[:, dg["node"]]
        else:
            gn = (g[:, dg["right"]] * coeff_a(dpad[:, dg["cell_up"]])
                  + g[:, dg["down"]] * coeff_a(dpad[:, dg["cell_left"]])
                  - g[:, dg["down_right"]] * coeff_b(dpad[:, dg["cell_here"]]))
            g[:, dg["node"]] = gn
        p = dpad[:, dg["cell"]]
        da = 0.5 + p / 6.0
        db = -p / 6.0
        dd[:, dg["cell"]] = gn * ((k[:, dg["left"]] + k[:, dg["up"]]) * da
                                  - k[:, dg["diag"]] * db)
    return dd.reshape(P, n + 1, m + 1)[:, :n, :m]


class Solve(torch.autograd.Function):
    """k[n, m] for Δ (P, n, m) -> (P,), with the exact adjoint."""

    @staticmethod
    def forward(ctx, delta):
        k = solve_grid(delta)
        ctx.save_for_backward(delta, k)
        P, n, m = delta.shape
        return k[:, n * (m + 2) + m].clone()

    @staticmethod
    def backward(ctx, gbar):
        delta, k = ctx.saved_tensors
        return adjoint(delta, k, gbar)


def solve(delta: torch.Tensor) -> torch.Tensor:
    """Kernel values for Δ (P, n, m) -> (P,), differentiable in Δ."""
    if delta.requires_grad:
        return Solve.apply(delta)
    P, n, m = delta.shape
    return solve_grid(delta)[:, n * (m + 2) + m]
