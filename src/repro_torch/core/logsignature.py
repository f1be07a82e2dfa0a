"""Log-signatures of paths, in PyTorch.

Counterpart of ``repro/core/logsignature.py``.  logS(x) = log(S(x)) lives in
the free Lie algebra, whose dimension (the number of Lyndon words) is much
smaller than the tensor algebra's.

Pipeline: increments --Horner--> S(x) --tensor_log--> flat Lie element
--Lyndon projection--> coordinates.  The Horner recursion is the same as
:mod:`repro_torch.core.signature`'s (the Hopper kernel B5 for backend
``"gpu"``); log and projection are a plain epilogue.  The backward pulls the
cotangent back through ``tensor_log`` and then runs the signature's §2.4
time-reversed backward (O(1) memory in the path length).

Modes (see :mod:`repro_torch.core.lyndon`): ``"lyndon"`` (default; a
gather), ``"brackets"`` (the Lyndon bracket basis) and ``"expand"`` (the
flat tensor layout of log(S(x)), sig_dim wide).
"""

from __future__ import annotations

import torch

from . import dispatch
from . import lyndon
from . import tensoralg as ta
from .config import resolve_kernel_configs, resolve_launch
from .signature import (_check_depth, _effective_increments,
                        _signature_horner_from_increments,
                        _signature_stream_from_increments, _stream_refusal,
                        signature_backward)
from .transforms import pad_ragged

MODES = ("lyndon", "brackets", "expand")


def logsignature_dim(d: int, depth: int, mode: str = "lyndon") -> int:
    """Output width of :func:`logsignature` for a (transformed) channel count d."""
    if mode == "expand":
        return ta.sig_dim(d, depth)
    return lyndon.logsig_dim(d, depth)


def _project(flat_log: torch.Tensor, d: int, depth: int, mode: str) -> torch.Tensor:
    if mode == "expand":
        return flat_log
    return lyndon.compress(flat_log, d, depth, mode)


def _check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode


class _LogSignatureCore(torch.autograd.Function):
    """Flat (``mode="expand"``) log-signature of increments z (..., L-1, d)
    by the plain Horner scan; backward through ``tensor_log``, then §2.4."""

    @staticmethod
    def forward(ctx, z, depth):
        d = z.shape[-1]
        sig = _signature_horner_from_increments(z, depth)
        ctx.save_for_backward(z, sig)
        ctx.depth = depth
        return ta.tensor_log(sig, d, depth)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        z, sig = ctx.saved_tensors
        d, depth = z.shape[-1], ctx.depth
        with torch.enable_grad():
            s = sig.detach().requires_grad_()
            (g_sig,) = torch.autograd.grad(ta.tensor_log(s, d, depth), s, g)
        return signature_backward(z, sig, g_sig, depth), None


def logsignature_from_increments(z: torch.Tensor, depth: int,
                                 mode: str = "lyndon") -> torch.Tensor:
    """Log-signature of increment streams z (..., L-1, d), plain path."""
    _check_mode(mode)
    return _project(_LogSignatureCore.apply(z, depth), z.shape[-1], depth, mode)


def logsignature(path: torch.Tensor, depth: int, *, mode: str = "lyndon",
                 transforms=None, backend: str = "auto", stream: bool = False,
                 lengths=None, launch=None) -> torch.Tensor:
    """Truncated log-signature of a batch of piecewise-linear paths.

    Args are those of :func:`repro_torch.core.signature.signature`, plus
    ``mode``: ``"lyndon"`` (default) | ``"brackets"`` | ``"expand"``.  The
    Lyndon projection is a final gather on every backend.  With
    ``stream=True`` the log-signatures of all prefixes come back
    (..., L-1, logsig_dim); ``backend="gpu"`` then raises.

    Returns:
      (..., logsignature_dim(d', depth, mode)), d' the transformed channel
      count.  Differentiable in ``path``.
    """
    depth = _check_depth(depth)
    _check_mode(mode)
    cfg = resolve_kernel_configs(transforms, None, None)[0]
    launch = resolve_launch(launch)
    if lengths is not None:
        path, lengths = pad_ragged(path, lengths)
    z = _effective_increments(path, cfg, lengths)
    d = z.shape[-1]
    backend = dispatch.canonicalize(backend, op="logsignature")
    if stream:
        if backend not in ("auto", "reference"):
            raise _stream_refusal("logsignature", backend)
        flat_log = ta.tensor_log(_signature_stream_from_increments(z, depth), d, depth)
        return _project(flat_log, d, depth, mode)
    backend = dispatch.resolve(backend, op="logsignature", device=z.device)
    if backend == "gpu":
        from repro_torch.kernels.signature import ops as sig_ops
        return sig_ops.logsignature_from_increments(z, depth, mode, launch)
    return logsignature_from_increments(z, depth, mode)


def logsignature_combine(lsa: torch.Tensor, lsb: torch.Tensor, d: int, depth: int,
                         mode: str = "lyndon") -> torch.Tensor:
    """Log-signature of a concatenation from the pieces' log-signatures:
    logS(x * y) = log(exp(logS(x)) ⊗ exp(logS(y))).  ``d`` is the
    (transformed) channel count the inputs were computed with."""
    _check_mode(mode)
    if mode != "expand":
        lsa = lyndon.expand(lsa, d, depth, mode)
        lsb = lyndon.expand(lsb, d, depth, mode)
    sa = ta.tensor_exp_full(lsa, d, depth)
    sb = ta.tensor_exp_full(lsb, d, depth)
    return _project(ta.tensor_log(ta.chen(sa, sb, d, depth), d, depth), d, depth, mode)
