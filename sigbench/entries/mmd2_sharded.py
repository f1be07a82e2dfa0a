"""The unbiased MMD² from three ``repro_torch.sigkernel_gram_sharded`` calls
over the run's mesh, assembled as ``losses.mmd2`` assembles it from dense
Grams, with its gradient in X on every rank.  Its pairs are those of
``mmd2`` (``entries/mmd2.py``), dealt over the ranks; its reference is the
same MMD²."""

import torch

from sigbench.counts import pde
from sigbench.entries import GOURSAT_SETTINGS as SETTINGS  # noqa: F401
from sigbench.entries import grad_of, modelled
from sigbench.entries import prepare_grid as prepare  # noqa: F401
from sigbench.reference import calls, control as ctl


def _mmd2(gram, X, Y, **kw):
    Kxx, Kyy, Kxy = gram(X, **kw), gram(Y, **kw), gram(X, Y, **kw)
    bx, by = X.shape[0], Y.shape[0]
    return ((Kxx.sum() - torch.trace(Kxx)) / (bx * (bx - 1))
            + (Kyy.sum() - torch.trace(Kyy)) / (by * (by - 1)) - 2.0 * Kxy.mean())


def call(rt, batch, ctx):
    X, Y = batch["x"], batch["y"]
    value = _mmd2(rt.sigkernel_gram_sharded, X, Y, mesh=ctx.mesh, grid=ctx.grid, **ctx.kwargs)
    return grad_of(value, X, ctx.grad)


def control(rt, batch, ctx):
    X, Y = batch["x"], batch["y"]
    return grad_of(_mmd2(ctl.gram, X, Y, grid=ctx.grid), X, ctx.grad)


def reference(batch, config, traffic):
    modelled(traffic.get("kwargs", {}))
    return calls.mmd2(batch["x"], batch["y"], lam=int(config["dyadic_order"]),
                      grad=bool(traffic["grad"]))


def counts(config, traffic):
    bx, by = config["x_shape"][0], config["y_shape"][0]
    return pde.goursat(config, traffic, fwd=pde.tri(bx) + pde.tri(by) + bx * by,
                       bwd=pde.tri(bx) + bx * by, pulled=2 * pde.tri(bx) + bx * by)
