"""The Horner kernel's split of the signature by its first indices, in
plain PyTorch on the CPU.

The redesigned kernel (``repro_torch/kernels/signature/csrc``) runs one
block per path and prefix of p first indices and never combines blocks.
``kernel.horner_slice_plain`` computes one such slice by the kernel's
per-step phases; ``kernel.horner_split_plain`` assembles all d^p of them.
Both must equal ``kernel.horner_plain`` bit for bit (every entry by the same
operations in the same order), and agree with the JAX package's reference
scan within the float32 tolerance of the other signature tests (5e-5).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import tensoralg as tta
from repro_torch.kernels.signature import kernel, ops

jsig = importlib.import_module("repro.core.signature")


def _incs(seed, B, L, d):
    z = np.random.default_rng(seed).normal(size=(B, L - 1, d)) / np.sqrt(L)
    return torch.from_numpy(z.astype(np.float32))


@pytest.mark.parametrize("d, N, p", [
    (3, 4, 0), (3, 4, 1), (3, 4, 2), (3, 4, 3), (2, 6, 1), (2, 6, 4), (1, 3, 2),
    (4, 1, 0), (5, 2, 1), (4, 3, 2), (9, 6, 2), (16, 5, 2)])
def test_split_assembles_to_horner_plain_bitwise(d, N, p):
    B, L = (2, 3) if d ** N > 10 ** 5 else (3, 7)
    z = _incs(d * 10 + N, B, L, d)
    assert torch.equal(kernel.horner_split_plain(z, N, p), kernel.horner_plain(z, N))


@pytest.mark.parametrize("d, N", [(3, 4), (8, 3), (4, 5)])
def test_each_slice_holds_its_entries(d, N):
    """A slice holds exactly the entries of the whole that begin with its
    prefix, level by level."""
    z = _incs(7, 2, 6, d)
    whole = tta.split_levels(kernel.horner_plain(z, N), d, N)
    for prefix in ([], [d - 1], [1, 0]):
        for k, level in enumerate(kernel.horner_slice_plain(z, N, prefix), start=1):
            full = whole[k - 1].reshape((2,) + (d,) * k)
            head = tuple(prefix[:k])
            want = full[(slice(None),) + head].reshape(2, -1)
            assert torch.equal(level, want), (prefix, k)


@pytest.mark.parametrize("d, N, p", [(3, 4, 1), (2, 5, 2), (4, 3, 1), (9, 3, 2)])
def test_split_matches_jax_reference(d, N, p):
    x = np.cumsum(np.random.default_rng(8).normal(size=(3, 9, d)) * 0.3, axis=1)
    x = x.astype(np.float32)
    want = jsig.signature(jnp.asarray(x), N, backend="reference")
    z = torch.from_numpy(x[:, 1:] - x[:, :-1])
    got = kernel.horner_split_plain(z, N, p)
    err = float(np.abs(got.numpy() - np.asarray(want)).max() / np.abs(np.asarray(want)).max())
    assert err <= 5e-5, err


def test_split_geometry_of_the_wrapper():
    """The prefix the wrapper picks for a launch, on the CPU: its slices
    assemble to the whole at the paper's widths, cut in length."""
    for d, N in [(4, 6), (8, 5), (9, 6)]:
        p = ops.geometry(128, 3, d, N)[0]
        z = _incs(9, 1, 3, d)
        assert torch.equal(kernel.horner_split_plain(z, N, p), kernel.horner_plain(z, N))
