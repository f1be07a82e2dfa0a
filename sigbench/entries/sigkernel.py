"""``repro_torch.sigkernel(x, y)``: k(x_p, y_p) for each pair p, with the
gradient of the sum of the values in x where the traffic asks.  One pair a
row: one solve forward and one sweep back a pair."""

from sigbench.counts import pde
from sigbench.entries import GOURSAT_SETTINGS as SETTINGS  # noqa: F401
from sigbench.entries import grad_of, modelled
from sigbench.entries import prepare_grid as prepare  # noqa: F401
from sigbench.reference import calls, control as ctl


def call(rt, batch, ctx):
    x, y = batch["x"], batch["y"]
    return grad_of(rt.sigkernel(x, y, grid=ctx.grid, **ctx.kwargs), x, ctx.grad)


def control(rt, batch, ctx):
    x, y = batch["x"], batch["y"]
    return grad_of(ctl.sigkernel(x, y, grid=ctx.grid), x, ctx.grad)


def reference(batch, config, traffic):
    modelled(traffic.get("kwargs", {}))
    return calls.sigkernel(batch["x"], batch["y"], lam=int(config["dyadic_order"]),
                           grad=bool(traffic["grad"]))


def counts(config, traffic):
    b = config["x_shape"][0]
    return pde.goursat(config, traffic, fwd=b, bwd=b, pulled=b)
