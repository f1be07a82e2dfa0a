"""Oracle for the Horner kernel: the *direct* algorithm (paper Alg 1), an
independently written scheme that shares no code path with Horner's.

Used by the tests and by chip_smoke.py only."""

from __future__ import annotations

import torch

from repro_torch.core.signature import _direct_step, _signature_scan


def signature_from_increments(z: torch.Tensor, depth: int) -> torch.Tensor:
    """Truncated signature from an increment stream z (..., L-1, d)."""
    return _signature_scan(z, z.shape[-1], depth, _direct_step)
