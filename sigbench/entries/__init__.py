"""The calls that a cell's window drives, one file an entry.

``entries/<entry>.py`` is found by the name that the traffic file gives
(``"entry"``); nothing else in the benchmark knows an entry by name.  An
entry module holds:

* ``SETTINGS``: for each configuration key that it and its reference read,
  the values they follow; the harness refuses a configuration outside them;
* ``prepare(rt, ctx)`` (optional): what every call shares, made once at
  set-up and set on ``ctx``;
* ``call(rt, batch, ctx)``: the port's call on one batch of the pool.  It
  returns ``(value, gradient)``: the gradient with respect to the batch's
  ``x`` where the traffic asks for one, else None.  It returns before the
  card has finished; the harness synchronises;
* ``control(rt, batch, ctx)``: the same call with the comparison's control
  (the plain reference one precision step down) in the program's place;
* ``reference(batch, config, traffic)``: the plain reference's
  ``(value, gradient)`` for the same batch.  It is given the traffic's
  ``kwargs`` as the port is, and refuses a keyword whose effect on the
  answer it does not model;
* ``counts(config, traffic)``: the work one call needs (``counts/``).

A batch is a dict with the paths ``x`` and ``y`` that ``inputs.py`` draws.
``ctx`` holds ``config``, ``traffic``, ``kwargs`` (the traffic's keywords
for the port's entry point), ``grad``, ``mesh`` (the cards' mesh, or None
on one card) and ``seed``, from which ``prepare`` draws anything more that
its calls take.  The helpers below serve the Goursat entries.
"""

from __future__ import annotations

import torch

from ..spec import load_module

#: the settings the Goursat entries and their reference follow: the
#: library's defaults, float32 with the linear lift and no transforms
GOURSAT_SETTINGS = {"dtype": ["float32"], "static_kernel": ["linear"], "transforms": [[]],
                    "exact": [True]}

#: keywords of the port's Goursat entry points that choose how the answer
#: is computed, not what it is
NEUTRAL_KWARGS = frozenset({"backend", "row_block", "streaming", "launch", "tile",
                            "row_axis", "col_axis"})


def load(name: str):
    """The entry module ``entries/<name>.py``."""
    return load_module("entries", name)


def grad_of(value: torch.Tensor, x: torch.Tensor, grad: bool):
    """``(value, d value.sum() / dx)``, or ``(value, None)`` without
    ``grad``."""
    if not grad:
        return value, None
    g, = torch.autograd.grad(value.sum(), x)
    return value.detach(), g


def prepare_grid(rt, ctx) -> None:
    """``ctx.grid``: the port's grid at the configuration's dyadic order."""
    lam = int(ctx.config["dyadic_order"])
    ctx.grid = rt.GridConfig(lam, lam)


def modelled(kwargs: dict) -> None:
    """Refuse the traffic's keywords that would change the answer: the
    reference computes the call without them."""
    odd = sorted(set(kwargs) - NEUTRAL_KWARGS)
    if odd:
        raise ValueError(f"the reference does not model the keywords {odd}: "
                         "give the call an entry of its own")
