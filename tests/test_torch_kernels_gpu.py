"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

The Goursat kernels (``repro_torch/kernels/sigkernel_pde/csrc``) have no CPU
mode: these tests need a CUDA card and skip without one.  The file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances, relative to the largest plain value: float32 1e-4, bf16
interiors 2e-2.  (The kernels round each operation as the plain versions do
and form the fused dot products in float64, so in practice they agree
exactly; the tolerances leave room for a dot product that lands within
1e-16 of a float32 rounding boundary.)
"""

import numpy as np
import pytest
import torch

from repro_torch.core.config import LaunchConfig
from repro_torch.kernels.sigkernel_pde import kernel, ops

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
COMBOS = [(scheme, idt, lam) for scheme in ("order1", "order2")
          for idt in ("float32", "bfloat16") for lam in ((0, 0), (1, 1), (2, 0))]
IDS = [f"{s}-{i}-lam{l1}{l2}" for s, i, (l1, l2) in COMBOS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Goursat kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _incs(seed, B, L, d, device):
    x = np.random.default_rng(seed).normal(size=(B, L, d)) / np.sqrt(L)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _close(got, want, rtol):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


@pytest.mark.gpu
@pytest.mark.parametrize("strip", [None, 16], ids=["auto_strip", "strip16"])
@pytest.mark.parametrize("scheme, idt, lam", COMBOS, ids=IDS)
@pytest.mark.parametrize("which", ["fwd", "fwd_fused", "gram_fused"])
def test_kernel_matches_plain(cuda, which, scheme, idt, lam, strip):
    """Lx = 44 increments: no multiple of a 16-row strip (nor, with lam1 = 2,
    of its 4 unrefined rows); 44 > 29 also makes nx > ny."""
    dx, dy = _incs(0, 4, 45, 5, cuda), _incs(1, 4, 30, 5, cuda)
    launch = LaunchConfig(pde_strip=strip)
    before = getattr(kernel, which).launches
    if which == "fwd":
        delta = torch.einsum("bid,bjd->bij", dx, dy)
        got = ops.solve(delta, *lam, launch, scheme, idt)
        want = kernel.solve_plain(delta, *lam, scheme, idt)
    elif which == "fwd_fused":
        got = ops.solve_fused(dx, dy, *lam, launch, scheme, idt)
        want = kernel.solve_fused_plain(dx, dy, *lam, scheme, idt)
    else:
        got = ops.gram_fused(dx, dy, *lam, launch, scheme, idt)
        want = kernel.gram_fused_plain(dx, dy, *lam, scheme, idt)
    assert getattr(kernel, which).launches == before + 1
    _close(got, want, TOL[idt])


@pytest.mark.gpu
def test_two_row_strips(cuda):
    """T = 2: row 1 overwrites the carried entry row 0 reads in the same step."""
    delta = torch.einsum("bid,bjd->bij", _incs(2, 3, 9, 3, cuda), _incs(3, 3, 12, 3, cuda))
    for scheme in ("order1", "order2"):
        got = ops.solve(delta, 0, 1, LaunchConfig(pde_strip=2), scheme)
        _close(got, kernel.solve_plain(delta, 0, 1, scheme, "float32"), TOL["float32"])


@pytest.mark.gpu
def test_launcher_checks_its_inputs(cuda):
    delta = torch.zeros(2, 5, 5, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kernel.fwd(delta.double(), 8, 0, 0, "order1", "float32")
    with pytest.raises(ValueError, match="contiguous"):
        kernel.fwd(delta.transpose(1, 2), 8, 0, 0, "order1", "float32")
    with pytest.raises(ValueError, match="pde_strip"):
        kernel.fwd(delta, 3, 0, 0, "order1", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.fwd(delta.cpu(), 8, 0, 0, "order1", "float32")
