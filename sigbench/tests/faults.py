"""Broken timed paths for the benchmark's own tests: each is a context
manager that patches the port, and ``harness.measure(fault="...")``
applies it in every rank around the warm-up and the window.  A run under
any of them has to come out with ``correct`` false.  Each cell's file
(``workloads/<cell>.json``, ``faults``) names the faults it can have, with
``"control"``: its entry's control in the program's place."""

from __future__ import annotations

import contextlib
import importlib
import sys
import types
from unittest import mock

import torch

import repro_torch
from repro_torch.parallel import collectives


# the modules, not the functions that ``repro_torch.core`` re-exports
gram_mod = importlib.import_module("repro_torch.core.gram")
sk_mod = importlib.import_module("repro_torch.core.sigkernel")


def _half_gram(orig):
    def gram(X, Y=None, **kw):
        """The Gram of the first half of each batch; the rest filled with
        its mean."""
        hx = X.shape[0] // 2
        Yh = None if Y is None else Y[: Y.shape[0] // 2]
        K = orig(X[:hx], Yh, **kw)
        by = X.shape[0] if Y is None else Y.shape[0]
        full = K.mean().expand(X.shape[0], by).clone()
        full[: K.shape[0], : K.shape[1]] = K
        return full
    return gram


@contextlib.contextmanager
def half_batch():
    """Half of each batch left out, the mean taken over the rest."""
    o_mmd2, o_sk, o_sh = repro_torch.mmd2, repro_torch.sigkernel, \
        repro_torch.sigkernel_gram_sharded

    def mmd2(X, Y, **kw):
        return o_mmd2(X[: X.shape[0] // 2], Y[: Y.shape[0] // 2], **kw)

    def sigkernel(x, y, **kw):
        h = x.shape[0] // 2
        k = o_sk(x[:h], y[:h], **kw)
        return torch.cat([k, k.mean().expand(x.shape[0] - h)])

    with mock.patch.object(repro_torch, "mmd2", mmd2), \
            mock.patch.object(repro_torch, "sigkernel", sigkernel), \
            mock.patch.object(repro_torch, "sigkernel_gram_sharded", _half_gram(o_sh)):
        yield


def _altered(orig):
    def solve(*args, **kw):
        """The solver's values with the first one altered by 1%."""
        k = orig(*args, **kw)
        bump = torch.zeros_like(k).reshape(-1)
        bump[0] = 0.01
        return k * (1.0 + bump.reshape(k.shape))
    return solve


@contextlib.contextmanager
def altered_answer():
    """One kernel value of every Goursat solve altered where it is produced."""
    with mock.patch.object(gram_mod, "_sigkernel_from_delta",
                           _altered(gram_mod._sigkernel_from_delta)), \
            mock.patch.object(sk_mod, "_sigkernel_from_delta",
                              _altered(sk_mod._sigkernel_from_delta)):
        yield


@contextlib.contextmanager
def no_exchange():
    """The exchange between ranks left out: each rank's own tiles stand for
    every rank's, and the replicated inputs' gradients are not summed."""
    def gather(x, group, dim=0):
        return torch.cat([x] * torch.distributed.get_world_size(group), dim)

    with mock.patch.object(collectives, "gather", gather), \
            mock.patch.object(collectives, "sum_grads", lambda x, groups: x):
        yield


@contextlib.contextmanager
def holds_flax():
    """Not a broken path: a module named ``flax`` left in the rank's
    process, which ``run.py`` has to refuse.  Only inside a rank process
    of a cell on several cards, which ends with its run."""
    if not torch.distributed.is_initialized():
        raise RuntimeError("holds_flax runs inside a spawned rank only")
    sys.modules.setdefault("flax", types.ModuleType("flax"))
    yield
