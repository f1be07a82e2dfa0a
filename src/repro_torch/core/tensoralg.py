"""Flattened truncated tensor algebra over R^d, in PyTorch.

Counterpart of ``repro/core/tensoralg.py``.  A group-like element (a
signature) is one flat tensor holding levels 1..N back to back::

    flat = [ A_1 (d floats) | A_2 (d^2 floats) | ... | A_N (d^N floats) ]

with the scalar level A_0 == 1 implicit.  ``d`` and ``depth`` are Python
ints; leading dimensions are batch dimensions.

Divisions by level numbers divide by a tensor on the operand's device, never
by a Python number: on CUDA, PyTorch turns a division by a CPU scalar into a
multiplication by its reciprocal, which rounds differently from the Horner
kernel's (and the JAX package's) true division.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def level_sizes(d: int, depth: int) -> List[int]:
    """Sizes of levels 1..depth: [d, d^2, ..., d^depth]."""
    return [d ** k for k in range(1, depth + 1)]


def sig_dim(d: int, depth: int) -> int:
    """Total flattened length of levels 1..depth."""
    return sum(level_sizes(d, depth))


def level_offsets(d: int, depth: int) -> List[int]:
    """Start offset of each level 1..depth inside the flat array."""
    offs, acc = [], 0
    for s in level_sizes(d, depth):
        offs.append(acc)
        acc += s
    return offs


def split_levels(flat: torch.Tensor, d: int, depth: int) -> List[torch.Tensor]:
    """Split a flat signature (..., sig_dim) into per-level views (..., d^k)."""
    out, off = [], 0
    for s in level_sizes(d, depth):
        out.append(flat[..., off:off + s])
        off += s
    return out


def join_levels(levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-level tensors back into a flat signature."""
    return torch.cat(list(levels), dim=-1)


# ---------------------------------------------------------------------------
# primitive tensor operations (flat level representation)
# ---------------------------------------------------------------------------

def divide(t: torch.Tensor, k) -> torch.Tensor:
    """``t / k`` as a true division (see the module docstring)."""
    return t / torch.tensor(float(k), dtype=t.dtype, device=t.device)


def outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tensor (outer) product of flat level tensors.

    a: (..., m) flat level-i, b: (..., n) flat level-j -> (..., m*n) level-(i+j).
    """
    return (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], -1)


def tensor_exp_levels(z: torch.Tensor, depth: int) -> List[torch.Tensor]:
    """Levels 1..depth of exp(z) = sum_k z^{⊗k}/k! for an increment z (..., d)."""
    levels = [z]
    for k in range(2, depth + 1):
        levels.append(outer(levels[-1], divide(z, k)))
    return levels


def tensor_exp(z: torch.Tensor, depth: int) -> torch.Tensor:
    """Flat signature of a linear segment with increment z (Proposition 2.1)."""
    return join_levels(tensor_exp_levels(z, depth))


def chen_levels(a: List[torch.Tensor], b: List[torch.Tensor],
                depth: int) -> List[torch.Tensor]:
    """Chen product on per-level lists: c_k = a_k + b_k + Σ_{i=1}^{k-1} a_i ⊗ b_{k-i}."""
    out = []
    for k in range(1, depth + 1):
        c = a[k - 1] + b[k - 1]
        for i in range(1, k):
            c = c + outer(a[i - 1], b[k - i - 1])
        out.append(c)
    return out


def chen(a: torch.Tensor, b: torch.Tensor, d: int, depth: int) -> torch.Tensor:
    """Chen's identity (Prop 2.2): signature of a concatenation, flat in / flat out."""
    return join_levels(
        chen_levels(split_levels(a, d, depth), split_levels(b, d, depth), depth))


def _levels_mul(a: List, b: List, depth: int) -> List:
    """Truncated product of two scalar-free elements given as level lists.

    Entries may be ``None`` (zero level); levels above ``depth`` are dropped.
    The result's level ``tot`` is Σ_i a_i ⊗ b_{tot-i}.
    """
    out: List = [None] * depth
    for tot in range(2, depth + 1):
        acc = None
        for i in range(1, tot):
            if a[i - 1] is None or b[tot - i - 1] is None:
                continue
            term = outer(a[i - 1], b[tot - i - 1])
            acc = term if acc is None else acc + term
        out[tot - 1] = acc
    return out


def _power_series(al: List[torch.Tensor], depth: int, coeff) -> List[torch.Tensor]:
    """Σ_{k>=1} coeff(k) · u^{⊗k} truncated at ``depth``, u given as levels."""
    out = [coeff(1) * x for x in al]
    power: List = list(al)
    for k in range(2, depth + 1):
        power = _levels_mul(power, al, depth)   # u^{⊗k}; levels < k are None
        c = coeff(k)
        for lvl in range(k, depth + 1):
            if power[lvl - 1] is not None:
                out[lvl - 1] = out[lvl - 1] + c * power[lvl - 1]
    return out


def sig_inverse(a: torch.Tensor, d: int, depth: int) -> torch.Tensor:
    """Group inverse of a signature: S(x)^{-1} = S(time-reversed x), the
    truncated inverse Σ_{k>=0} (-1)^k (a - 1)^{⊗k}."""
    al = split_levels(a, d, depth)
    return join_levels(_power_series(al, depth, lambda k: (-1.0) ** k))


def tensor_log(a: torch.Tensor, d: int, depth: int) -> torch.Tensor:
    """Truncated log of a group-like element: log(1 + u) =
    Σ_{k>=1} (-1)^{k+1} u^{⊗k} / k with u = a (flat, scalar part implicit).
    Its Lyndon-coordinate projection is :func:`repro_torch.core.lyndon.compress`."""
    al = split_levels(a, d, depth)
    return join_levels(_power_series(al, depth, lambda k: (-1.0) ** (k + 1) / k))


def tensor_exp_full(a: torch.Tensor, d: int, depth: int) -> torch.Tensor:
    """Truncated exp of an arbitrary scalar-free element (flat in / flat out):
    exp(u) = Σ_{k>=0} u^{⊗k}/k!, the inverse of :func:`tensor_log`."""
    al = split_levels(a, d, depth)
    return join_levels(_power_series(al, depth, lambda k: 1.0 / math.factorial(k)))


def sig_inner(a: torch.Tensor, b: torch.Tensor, d: int, depth: int,
              include_scalar: bool = True) -> torch.Tensor:
    """Standard (Euclidean tensor) inner product ⟨a, b⟩ over levels 0..depth."""
    ip = (a * b).sum(-1)
    if include_scalar:
        ip = ip + 1.0  # level-0 contribution 1*1
    return ip


def identity_like(batch_shape, d: int, depth: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Flat representation of the group identity (1, 0, 0, ...)."""
    return torch.zeros((*batch_shape, sig_dim(d, depth)), dtype=dtype, device=device)
