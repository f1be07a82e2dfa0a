"""Truncated path signatures (pySigLib §2) in PyTorch.

Counterpart of ``repro/core/signature.py``.  Both algorithms of the paper:

* Algorithm 1 — the *direct* update, kept as an independently written
  oracle (:func:`signature_direct`);
* Algorithm 2 — *Horner's scheme*, the production path: the plain scan here
  (backend ``"reference"``), the Hopper kernel B5 on the card (backend
  ``"gpu"``, :mod:`repro_torch.kernels.signature`).

Backpropagation (§2.4) is the time-reversed deconstruction: the backward
never stores per-step signatures; it rebuilds S(x_{1:ℓ}) from S(x_{1:ℓ+1})
by a Chen product with exp(−z_ℓ), the signature of the reversed segment,
and pulls the cotangent through one step at a time, so its memory is O(1)
in the path length.  Both backends share it (:func:`signature_backward`).
"""

from __future__ import annotations

from typing import List

import torch

from . import dispatch
from . import tensoralg as ta
from .config import resolve_kernel_configs, resolve_launch
from .transforms import pad_ragged, pipeline_increments


# ---------------------------------------------------------------------------
# increments (with the §4 transforms applied on the fly)
# ---------------------------------------------------------------------------

def path_increments(path: torch.Tensor) -> torch.Tensor:
    """z_ℓ = x_{ℓ+1} − x_ℓ along the second-to-last axis."""
    return path[..., 1:, :] - path[..., :-1, :]


def _effective_increments(path: torch.Tensor, pipeline, lengths=None) -> torch.Tensor:
    """Increments of the transformed path, never the path itself.  With
    ``lengths=`` the padded increments are zeros after the valid ones:
    exact no-ops for the Horner recursion."""
    return pipeline_increments(path, pipeline, lengths, align="start")


def transformed_dim(d: int, time_aug: bool, lead_lag: bool) -> int:
    """Channel dimension after the transforms (see
    :meth:`TransformPipeline.transformed_dim`)."""
    if lead_lag:
        d = 2 * d
    if time_aug:
        d = d + 1
    return d


def _check_depth(depth) -> int:
    if not isinstance(depth, int) or isinstance(depth, bool) or depth < 1:
        raise ValueError(f"depth must be a positive Python int, got {depth!r}")
    return depth


# ---------------------------------------------------------------------------
# Algorithm 1 — direct
# ---------------------------------------------------------------------------

def _direct_step(levels: List[torch.Tensor], z: torch.Tensor,
                 depth: int) -> List[torch.Tensor]:
    """A_k <- Σ_{i=0}^{k} A_i ⊗ z^{⊗(k-i)}/(k-i)!  (reverse level order)."""
    ez = ta.tensor_exp_levels(z, depth)
    new = list(levels)
    for k in range(depth, 0, -1):
        acc = levels[k - 1] + ez[k - 1]
        for i in range(1, k):
            acc = acc + ta.outer(levels[i - 1], ez[k - i - 1])
        new[k - 1] = acc
    return new


# ---------------------------------------------------------------------------
# Algorithm 2 — Horner
# ---------------------------------------------------------------------------

def _horner_step(levels: List[torch.Tensor], z: torch.Tensor,
                 depth: int) -> List[torch.Tensor]:
    """One path step of Horner's scheme (Alg 2), in the Hopper kernel's order
    of operations:

        A_k = (B_k + A_{k-1}) ⊗ z + A_k,
        B_k = ((...((z/k + A_1) ⊗ z/(k-1) + A_2) ⊗ z/(k-2) + ...) ⊗ z/2)
    """
    new = list(levels)
    for k in range(depth, 1, -1):
        b = ta.divide(z, k)
        for i in range(1, k - 1):
            b = ta.outer(b + levels[i - 1], ta.divide(z, k - i))
        b = b + levels[k - 2]               # + A_{k-1}
        new[k - 1] = ta.outer(b, z) + levels[k - 1]
    new[0] = levels[0] + z
    return new


# ---------------------------------------------------------------------------
# full signatures
# ---------------------------------------------------------------------------

def _signature_scan(z: torch.Tensor, d: int, depth: int, step_fn) -> torch.Tensor:
    """Fold a per-step update over the increment stream z (..., L-1, d)."""
    dispatch.record_scan_steps(z.shape[-2])
    batch_shape = z.shape[:-2]
    levels = [z.new_zeros((*batch_shape, s)) for s in ta.level_sizes(d, depth)]
    for t in range(z.shape[-2]):
        levels = step_fn(levels, z[..., t, :], depth)
    return ta.join_levels(levels)


def signature_direct(path: torch.Tensor, depth: int, *, transforms=None) -> torch.Tensor:
    """Truncated signature via Algorithm 1 (direct).  Cross-check oracle."""
    cfg = resolve_kernel_configs(transforms, None, None)[0]
    z = _effective_increments(path, cfg)
    return _signature_scan(z, z.shape[-1], _check_depth(depth), _direct_step)


def _signature_horner_from_increments(z: torch.Tensor, depth: int) -> torch.Tensor:
    return _signature_scan(z, z.shape[-1], depth, _horner_step)


def signature_backward(z: torch.Tensor, sig: torch.Tensor, g: torch.Tensor,
                       depth: int) -> torch.Tensor:
    """∂F/∂z (..., L-1, d) from the increments, the signature they give and
    ḡ = ∂F/∂S, by the §2.4 time-reversed deconstruction.

    Going backwards over the steps, S_before = S_after ⊗ exp(−z_ℓ), then the
    VJP of the one step S_before ⊗ exp(z_ℓ) gives ∂F/∂S_before and ∂F/∂z_ℓ.
    Only the current signature and its cotangent are live: O(1) memory in L.
    """
    d = z.shape[-1]
    gz = torch.empty_like(z)
    s_after, g_after = sig, g
    for t in range(z.shape[-2] - 1, -1, -1):
        zt = z[..., t, :]
        s_before = ta.chen(s_after, ta.tensor_exp(-zt, depth), d, depth)
        with torch.enable_grad():
            s_in = s_before.detach().requires_grad_()
            z_in = zt.detach().requires_grad_()
            out = ta.chen(s_in, ta.tensor_exp(z_in, depth), d, depth)
            g_after, gz[..., t, :] = torch.autograd.grad(out, (s_in, z_in), g_after)
        s_after = s_before
    return gz


class _SignatureCore(torch.autograd.Function):
    """The plain Horner scan, differentiated by :func:`signature_backward`."""

    @staticmethod
    def forward(ctx, z, depth):
        sig = _signature_horner_from_increments(z, depth)
        ctx.save_for_backward(z, sig)
        ctx.depth = depth
        return sig

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        z, sig = ctx.saved_tensors
        return signature_backward(z, sig, g, ctx.depth), None


def _signature_core(z: torch.Tensor, depth: int) -> torch.Tensor:
    return _SignatureCore.apply(z, depth)


def _stream_refusal(op: str, backend: str) -> ValueError:
    return ValueError(
        f"{op}(stream=True) has no {backend!r} implementation — the streamed "
        "prefix scan is plain PyTorch; pass backend='auto' or backend='reference'")


def signature(path: torch.Tensor, depth: int, *, transforms=None, backend: str = "auto",
              stream: bool = False, lengths=None, launch=None) -> torch.Tensor:
    """Truncated signature of a batch of piecewise-linear paths.

    Args:
      path: (..., L, d) discrete stream; linearly interpolated.
      depth: truncation level N.
      transforms: a :class:`repro_torch.TransformPipeline` (basepoint /
        lead-lag / time-aug over [t0, t1]), applied to the increments on the
        fly.  Default: no transforms.
      backend: ``"reference"`` (the plain Horner scan, any device),
        ``"gpu"`` (the Hopper Horner kernel; CUDA tensors only) or
        ``"auto"``: ``"gpu"`` for CUDA tensors, ``"reference"`` for CPU
        tensors.  With ``stream=True`` only ``"auto"`` / ``"reference"`` are
        valid (the streamed scan is plain PyTorch); ``"gpu"`` raises.
      stream: if True return the signatures of all prefixes
        (..., L-1, sig_dim).
      lengths: optional (...,) integer per-path true point counts (ragged
        batches).  Padding is ignored, the time grid ends at ``t1`` at each
        true last point, and the length axis is padded to a power-of-two
        bucket (:func:`pad_ragged`).  Streamed prefixes past a path's end
        repeat its final signature.
      launch: an optional :class:`repro_torch.LaunchConfig`; ``sig_lb`` caps
        the increments the kernel stages per block.  Launch settings never
        change the arithmetic: results are bitwise equal across them.
        Ignored by the reference backend and the streamed scan.

    Returns:
      (..., sig_dim(d', depth)), levels 1..depth flat, d' the transformed
      channel count (``transforms.transformed_dim(d)``).  Differentiable in
      ``path`` with the O(1)-memory backward of §2.4.
    """
    depth = _check_depth(depth)
    cfg = resolve_kernel_configs(transforms, None, None)[0]
    launch = resolve_launch(launch)
    if lengths is not None:
        path, lengths = pad_ragged(path, lengths)
    z = _effective_increments(path, cfg, lengths)
    backend = dispatch.canonicalize(backend, op="signature")
    if stream:
        if backend not in ("auto", "reference"):
            raise _stream_refusal("signature", backend)
        return _signature_stream_from_increments(z, depth)
    backend = dispatch.resolve(backend, op="signature", device=z.device,
                               shape=(z.shape[-2], z.shape[-1], depth), dtype=z.dtype,
                               ragged=lengths is not None)
    if backend == "gpu":
        from repro_torch.kernels.signature import ops as sig_ops
        return sig_ops.signature_from_increments(z, depth, launch)
    return _signature_core(z, depth)


def _signature_stream_from_increments(z: torch.Tensor, depth: int) -> torch.Tensor:
    """All prefix signatures (..., L-1, sig_dim); differentiable by autograd."""
    dispatch.record_scan_steps(z.shape[-2])
    d = z.shape[-1]
    levels = [z.new_zeros((*z.shape[:-2], s)) for s in ta.level_sizes(d, depth)]
    prefixes = []
    for t in range(z.shape[-2]):
        levels = _horner_step(levels, z[..., t, :], depth)
        prefixes.append(ta.join_levels(levels))
    if not prefixes:
        return z.new_zeros((*z.shape[:-2], 0, ta.sig_dim(d, depth)))
    return torch.stack(prefixes, dim=-2)


def signature_combine(sig_a: torch.Tensor, sig_b: torch.Tensor, d: int,
                      depth: int) -> torch.Tensor:
    """Chen-combine the signatures of consecutive path segments."""
    return ta.chen(sig_a, sig_b, d, depth)
