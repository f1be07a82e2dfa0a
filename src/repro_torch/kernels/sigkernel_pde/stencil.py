"""Goursat cell-update stencils, their derivatives and the interior
rounding, in PyTorch.

Counterpart of ``repro/kernels/sigkernel_pde/stencil.py``: every PDE path
of the port (row scan, anti-diagonal wavefront, the CUDA kernels' plain
versions, forward and backward) takes its coefficients from here.

``order1`` (the paper's eq. (1))::

    k̂_{i+1,j+1} = (k̂_{i+1,j} + k̂_{i,j+1})·A(p) − k̂_{i,j}·B₁(p)
    A(p) = 1 + p/2 + p²/12,   B₁(p) = 1 − p²/12.

``order2`` adds an anti-diagonal curvature correction::

    k̂_{i+1,j+1} = (k̂_{i+1,j} + k̂_{i,j+1})·A(p) − k̂_{i,j}·B₂(p)
                  − C(p)·(k̂_{i+1,j−1} + k̂_{i−1,j+1})
    B₂(p) = 1 − p/6 + p²/12,   C(p) = p/12,

and falls back to order 1 on unrefined data gridlines
(``i % 2^λ1 == 0 or j % 2^λ2 == 0``), where Δ kinks.  The CUDA kernels in
``csrc/sigkernel_pde.cu`` write the same expressions.

:func:`delta_einsum` forms Δ = ⟨dx_i, dy_j⟩ as the correctly rounded dot
products (float64 accumulation, one rounding), which is what the fused
kernels build in-kernel: every route then sees the same Δ.

The adjoint (dΔ) coefficients ``coeff_d*`` are the derivatives of the
above in p.  They divide by 6 as a multiplication by the float32 reciprocal
(``p * (1/6)``), which is what PyTorch's CUDA division by a scalar and the
CUDA kernels both compute, so the backward kernel and its plain version
agree bit for bit on the card.

``round_interior(x, "bfloat16")`` rounds each new interior cell through
bf16 (round to nearest even) and back; boundaries and the readout stay in
the working precision.  Its gradient is straight-through: the cotangent
passes unchanged (never rounded), as in the JAX package's ``_round_bf16``,
so autograd through a bf16-interior forward is the exact adjoint the
one-pass backward computes.
"""

from __future__ import annotations

import torch

#: cell-update stencils
SCHEMES = ("order1", "order2")

#: interior-cell storage precisions (boundary/readout stay f32 or wider)
INTERIOR_DTYPES = ("float32", "bfloat16")


def check_scheme(scheme: str) -> str:
    """Validate a scheme name."""
    if scheme not in SCHEMES:
        raise ValueError(
            f"unknown Goursat scheme {scheme!r}: GridConfig.scheme must be "
            f"one of {SCHEMES}")
    return scheme


def check_interior_dtype(interior_dtype: str) -> str:
    """Validate an interior-dtype name."""
    if interior_dtype not in INTERIOR_DTYPES:
        raise ValueError(
            f"unknown interior dtype {interior_dtype!r}: "
            f"GridConfig.interior_dtype must be one of {INTERIOR_DTYPES}")
    return interior_dtype


def coeff_A(p):
    return 1.0 + 0.5 * p + (1.0 / 12.0) * p * p


def coeff_B1(p):
    return 1.0 - (1.0 / 12.0) * p * p


def coeff_B2(p):
    return 1.0 - (1.0 / 6.0) * p + (1.0 / 12.0) * p * p


def coeff_C2(p):
    return (1.0 / 12.0) * p


def coeff_B2_at(p, edge):
    """Per-cell B for order2: B₁ where ``edge`` (order-1 fallback), else B₂."""
    return torch.where(edge, coeff_B1(p), coeff_B2(p))


def coeff_C2_at(p, edge):
    """Per-cell C for order2: 0 where ``edge`` (order-1 fallback), else C."""
    return torch.where(edge, torch.zeros_like(p), coeff_C2(p))


# ---------------------------------------------------------------------------
# adjoint (dΔ) coefficients — derivatives of the above w.r.t. p
# ---------------------------------------------------------------------------

_SIXTH = 1.0 / 6.0


def coeff_dA(p):
    return 0.5 + p * _SIXTH


def coeff_dB1(p):
    return p * -_SIXTH


def coeff_dB2(p):
    return p * _SIXTH - _SIXTH


def coeff_dC2(p):
    return torch.full_like(p, 1.0 / 12.0)


def coeff_dB(p, scheme: str = "order1"):
    """Scheme-dispatched B'(p) (B₁' for order1, B₂' for order2)."""
    return coeff_dB2(p) if scheme == "order2" else coeff_dB1(p)


def coeff_dB2_at(p, edge):
    """Per-cell B' for order2 dΔ: B₁' where ``edge``, else B₂'."""
    return torch.where(edge, coeff_dB1(p), coeff_dB2(p))


def coeff_dC2_at(p, edge):
    """Per-cell C' for order2 dΔ: 0 where ``edge``, else 1/12."""
    return torch.where(edge, torch.zeros_like(p), coeff_dC2(p))


# ---------------------------------------------------------------------------
# mixed-precision rounding
# ---------------------------------------------------------------------------

class _RoundBF16(torch.autograd.Function):
    """f32 -> bf16 -> f32 round trip with an identity (straight-through)
    backward."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        return ct


def round_interior(x: torch.Tensor, interior_dtype: str = "float32") -> torch.Tensor:
    """Quantise a freshly updated interior cell: identity for ``"float32"``,
    a round trip through bf16 (nearest even) for ``"bfloat16"``, whose
    gradient is the exact identity cotangent."""
    if interior_dtype == "float32":
        return x
    return _RoundBF16.apply(x)


def delta_einsum(spec: str, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``einsum(spec, dx, dy)`` accumulated in float64 and rounded once to
    ``dx``'s dtype: Δ as correctly rounded dot products."""
    return torch.einsum(spec, dx.double(), dy.double()).to(dx.dtype)
