"""Wrapper for the Horner signature kernel.

Counterpart of ``repro/kernels/signature/ops.py``.  Responsibilities:

* dtype discipline: the kernel computes in float32 (bf16/f16 inputs are
  upcast, float64 is cast down, as ``ops.py:73-76`` does) and the result is
  cast back to the input dtype; the CPU path keeps at least float32;
* batch flattening;
* the launch geometry for this card: the length block S (increments staged
  in shared memory per block, :func:`choose_lb`) and the threads per block
  (:func:`choose_threads`).  One block runs one path, so the batch needs no
  padding, and the last length block stages only the steps that remain, so
  the length needs none either (zero increments would be exact no-ops);
  neither changes the arithmetic: results are bitwise equal across
  ``launch=`` settings;
* device routing: a CUDA tensor launches the kernel (or raises), a CPU
  tensor takes :func:`kernel.horner_plain`.  There is no fallback between
  the two;
* gradients: :func:`signature_from_increments` is a
  ``torch.autograd.Function`` whose backward is the §2.4 time-reversed
  deconstruction in plain PyTorch (:func:`repro_torch.core.signature.
  signature_backward`), as in the JAX package, whose Horner kernel has no
  backward kernel either.
"""

from __future__ import annotations

import torch

from . import kernel

#: default cap on the length block: staging more steps only saves round
#: trips of the top level through L2, which are few by then
_MAX_LB = 64


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def choose_lb(n_steps: int, d: int, depth: int, max_lb=None) -> int:
    """Increments staged per length block: the most, up to ``max_lb`` (a
    ``LaunchConfig.sig_lb`` cap; default 64) and the path's steps, whose
    shared memory fits one H100 block.  Raises ValueError when even one
    step does not fit (the levels below the top are too large)."""
    S = max(1, min(max_lb or _MAX_LB, n_steps))
    while S > 1 and kernel.smem_bytes(d, depth, S) > kernel.SMEM_LIMIT:
        S -= 1
    if kernel.smem_bytes(d, depth, S) > kernel.SMEM_LIMIT:
        raise ValueError(
            f"the Horner kernel cannot hold levels 1..{depth - 1} of a d={d} "
            f"signature in one H100 block ({kernel.smem_bytes(d, depth, 1)} bytes of "
            f"shared memory, limit {kernel.SMEM_LIMIT}) — lower the depth, or pass "
            f"backend='reference' for the plain scan on the card")
    return S


def choose_threads(d: int, depth: int, max_threads=None) -> int:
    """Threads per block: d^(N-1) (the widest level below the top) rounded
    up to a power of two, within [32, ``max_threads``] (a
    ``LaunchConfig.sig_bt`` cap; default 1024)."""
    cap = min(max_threads or kernel.MAX_THREADS, kernel.MAX_THREADS)
    return max(32, min(cap, _pow2_ceil(d ** (depth - 1))))


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}: use 'cuda' or 'cpu'")
    return t.device.type


def _horner(flat: torch.Tensor, depth: int, launch) -> torch.Tensor:
    """(B, n, d) increments -> (B, sig_dim) signatures, in the working dtype."""
    if _route(flat) == "cuda":
        zc = flat.to(torch.float32).contiguous()
        _, n, d = zc.shape
        S = choose_lb(n, d, depth, getattr(launch, "sig_lb", None))
        threads = choose_threads(d, depth, getattr(launch, "sig_bt", None))
        return kernel.horner(zc, depth, S, threads)
    return kernel.horner_plain(flat.to(torch.promote_types(flat.dtype, torch.float32)),
                               depth)


class _Horner(torch.autograd.Function):
    """B5 (or its plain version on the CPU) forward; the §2.4 backward."""

    @staticmethod
    def forward(ctx, z, depth, launch):
        flat = z.reshape((-1,) + tuple(z.shape[-2:]))
        sig = _horner(flat, depth, launch)
        ctx.save_for_backward(z, sig)
        ctx.depth = depth
        return sig.reshape(z.shape[:-2] + sig.shape[-1:]).to(z.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from repro_torch.core.signature import signature_backward
        z, sig = ctx.saved_tensors
        work = sig.dtype
        flat = z.reshape((-1,) + tuple(z.shape[-2:])).to(work)
        gz = signature_backward(flat, sig, g.reshape(sig.shape).to(work), ctx.depth)
        return gz.reshape(z.shape).to(z.dtype), None, None


def signature_from_increments(z: torch.Tensor, depth: int, launch=None) -> torch.Tensor:
    """Truncated signatures of increment streams z (..., L-1, d) through the
    Horner kernel (..., sig_dim), differentiable in z.

    ``launch`` is an optional :class:`repro_torch.LaunchConfig`: ``sig_lb``
    caps the length block, ``sig_bt`` the threads per block.  Neither
    changes the per-path arithmetic.
    """
    return _Horner.apply(z, depth, launch)


def logsignature_from_increments(z: torch.Tensor, depth: int, mode: str = "lyndon",
                                 launch=None) -> torch.Tensor:
    """Increments -> log-signature through the same Horner kernel, with the
    log and the Lyndon projection as a plain epilogue (a fixed polynomial in
    the levels, then an ``index_select``, or an ``index_select`` and a
    matmul for ``mode="brackets"``).  Gradients compose the signature's
    §2.4 backward with autograd through the epilogue."""
    from repro_torch.core.logsignature import MODES, _project
    from repro_torch.core.tensoralg import tensor_log
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    d = z.shape[-1]
    sig = signature_from_increments(z, depth, launch)
    return _project(tensor_log(sig, d, depth), d, depth, mode)
