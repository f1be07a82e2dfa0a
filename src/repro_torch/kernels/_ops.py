"""The port's ``torch.library`` ops: the ``repro_torch`` namespace.

Each Goursat solve (and the RFF feature scan) is one op with a fake
implementation that gives its outputs' shapes alone.  A trace on fake
tensors (``FakeTensorMode``: the streaming guard of ``core/gram.py``, the
dry run) then sees one op a solve, launches nothing and never enters a
ctypes call or a Python loop over cells.  The ops are defined on a library
fragment, not with ``torch.library.custom_op``, whose wrapper imports
``torch._dynamo`` on an op's first call (seconds of a process's start).
They take no input that requires grad: ``torch.autograd.Function``s around
them carry the gradients.
"""

from __future__ import annotations

import torch

_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def define(name: str, schema: str, fake, **impls):
    """Define ``repro_torch::<name>`` with ``schema`` (``"(Tensor x, ...)
    -> Tensor"``), its implementation for each dispatch key in ``impls``
    (``CPU=``, ``CUDA=``, or ``CompositeExplicitAutograd=`` for every
    device) and its fake implementation; return the op."""
    _LIB.define(name + schema)
    for key, fn in impls.items():
        _LIB.impl(name, fn, key)
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    return getattr(torch.ops.repro_torch, name).default
