"""``repro_torch.mmd2(X, Y)``: the unbiased MMD² between the batches X and
Y under the signature kernel, with its gradient in X where the traffic asks.

It solves the upper triangles of the two symmetric Grams (the diagonal
included, as the Gram engine does and ``count_pair_solves`` counts) and the
whole cross Gram; its gradient sweeps back the X-X and X-Y pairs.
"""

from sigbench.counts import pde
from sigbench.entries import GOURSAT_SETTINGS as SETTINGS  # noqa: F401
from sigbench.entries import grad_of, modelled
from sigbench.entries import prepare_grid as prepare  # noqa: F401
from sigbench.reference import calls, control as ctl


def call(rt, batch, ctx):
    X, Y = batch["x"], batch["y"]
    return grad_of(rt.mmd2(X, Y, grid=ctx.grid, **ctx.kwargs), X, ctx.grad)


def control(rt, batch, ctx):
    X, Y = batch["x"], batch["y"]
    return grad_of(ctl.mmd2(X, Y, grid=ctx.grid), X, ctx.grad)


def reference(batch, config, traffic):
    modelled(traffic.get("kwargs", {}))
    return calls.mmd2(batch["x"], batch["y"], lam=int(config["dyadic_order"]),
                      grad=bool(traffic["grad"]))


def counts(config, traffic):
    bx, by = config["x_shape"][0], config["y_shape"][0]
    return pde.goursat(config, traffic, fwd=pde.tri(bx) + pde.tri(by) + bx * by,
                       bwd=pde.tri(bx) + bx * by, pulled=2 * pde.tri(bx) + bx * by)
