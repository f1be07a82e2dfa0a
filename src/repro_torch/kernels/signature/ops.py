"""Wrapper for the Horner signature kernel.

Counterpart of ``repro/kernels/signature/ops.py``.  Responsibilities:

* dtype discipline: the kernel computes in float32 (bf16/f16 inputs are
  upcast, float64 is cast down, as ``ops.py:73-76`` does) and the result is
  cast back to the input dtype; the CPU path keeps at least float32;
* batch flattening;
* the launch geometry for this card (:func:`geometry`): the prefix length
  p (the kernel runs one block per path and prefix of p first indices),
  the top-level column chunk, the chunk width of the lower levels' rows,
  the length block S (increments staged in shared memory per block) and
  the threads per block.  The last length
  block stages only the steps that remain, so the length needs no padding
  (zero increments would be exact no-ops); none of these changes the
  arithmetic: results are bitwise equal across ``launch=`` settings;
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

#: default cap on the length block, the increments (and their z/m) a block
#: stages at once: one staging barrier per S steps against S * N * d floats
#: of shared memory
_MAX_LB = 32
#: shared memory a block aims at (S shrinks to fit): four blocks of the
#: paper's widths then fit one SM
_SMEM_BUDGET = 48 * 1024
#: the prefix grows until the launch has this many blocks (or the top
#: slice is one row): a block's steps are latency-bound, so the SMs need
#: several blocks each; more, smaller slices than that only add waves
#: (a prefix sweep on an H100: p = 1 beat p = 2 at (128, 256, 4, 6))
_MIN_BLOCKS = 512
_MAX_GRID = 2 ** 31 - 1


def _chunk(d: int) -> int:
    """Chunk width of the lower-level rows: whole rows up to ``kernel.CHUNK``
    entries (an item's fixed cost, its Horner chain and its offsets,
    outweighs its length)."""
    return min(kernel.CHUNK, 1 << max(0, d - 1).bit_length())


def geometry(B: int, n_steps: int, d: int, depth: int, max_threads=None,
             max_lb=None):
    """Launch geometry of the Horner kernel, ``(p, jw, cw, S, threads)``.

    p: the shortest prefix whose step fits one block of at most
    ``max_threads`` (a ``LaunchConfig.sig_bt`` cap, at least one warp;
    default ``kernel.MAX_THREADS``) threads, one a row item
    (``kernel.row_items``) and one a tile of ``kernel.TOP`` top-level rows; lengthened while the
    launch has fewer than ``_MIN_BLOCKS`` blocks.  jw: the top-level
    columns a block keeps, d unless d alone exceeds the threads (then the
    columns are cut into chunks, one block each).  cw: the chunk width of
    the rows (:func:`_chunk`).  S: increments staged per length block, the
    most up to ``max_lb`` (a ``LaunchConfig.sig_lb`` cap; default 32) and
    the path's steps within ``_SMEM_BUDGET`` (at least 1).  Raises
    ValueError only where one increment and its quotients do not fit one
    block's shared memory (d * depth above ~57,000).
    """
    cap = max(32, min(max_threads or kernel.MAX_THREADS, kernel.MAX_THREADS))
    p_hi = max(depth - 1, 0)

    def fit(p, jw):
        cw = _chunk(d)
        threads = kernel.threads_needed(d, depth, p, jw, cw)
        if threads <= cap and kernel.smem_bytes(d, depth, p, cw, 1, threads) \
                <= kernel.SMEM_LIMIT:
            return cw, threads
        return None

    p = next((p for p in range(p_hi + 1) if fit(p, d)), None)
    if p is not None:
        jw = d
        while (p < p_hi and B * d ** p < _MIN_BLOCKS and B * d ** (p + 1) <= _MAX_GRID
               and fit(p + 1, d)):
            p += 1
    else:  # the top slice is one row: cut its d columns into chunks
        p, jw = p_hi, min(d, cap)
        if not fit(p, jw):
            raise ValueError(
                f"the Horner kernel cannot stage one increment of d={d} channels and "
                f"its {depth - 1} quotients in one H100 block (limit "
                f"{kernel.SMEM_LIMIT} bytes of shared memory) — pass "
                f"backend='reference' for the plain scan")
    cw, threads = fit(p, jw)
    S = max(1, min(max_lb or _MAX_LB, n_steps))
    while S > 1 and kernel.smem_bytes(d, depth, p, cw, S, threads) > _SMEM_BUDGET:
        S -= 1
    return p, jw, cw, S, threads


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}: use 'cuda' or 'cpu'")
    return t.device.type


def _horner(flat: torch.Tensor, depth: int, launch) -> torch.Tensor:
    """(B, n, d) increments -> (B, sig_dim) signatures, in the working dtype."""
    if _route(flat) == "cuda":
        zc = flat.to(torch.float32).contiguous()
        B, n, d = zc.shape
        geo = geometry(B, n, d, depth, getattr(launch, "sig_bt", None),
                       getattr(launch, "sig_lb", None))
        return kernel.horner(zc, depth, *geo)
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
    caps the length block, ``sig_bt`` the threads per block (a lower cap
    splits the signature into more, smaller slices).  Neither changes the
    per-path arithmetic.
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
