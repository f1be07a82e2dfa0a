"""How the fused Goursat kernels build Δ, in plain PyTorch on the CPU.

The fused kernels (``repro_torch/kernels/sigkernel_pde/csrc``,
``goursat_fwd_fused``) build each strip's Δ band by band, as 16 x 8 tile
products on the FP64 tensor cores, through staged dx rows, a dy ring and a
skewed band in shared memory.  ``kernel.fused_band_plain`` assembles Δ the
same way: row blocks, column tiles, k padding, tile skipping, ring slots,
skew and refinement, with every band entry no tile wrote and every ring row
not yet loaded set to NaN.

The inputs are multiples of 1/8 in [-1, 1], so every dot product is exact in
float64 whatever the order of its sums: the band assembly must then equal
``stencil.delta_einsum`` exactly, and any difference is an index, a tile, a
ring slot or a skew gone wrong.  (On random data the kernel's float64 sums may round
in another order than the einsum's; the file header of the CUDA source and
``test_torch_kernels_gpu.py`` state that tolerance.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sigkernel_pde import ops as jops
from repro_torch.kernels.sigkernel_pde import kernel, ops, stencil

STRIPS = (2, 4, 16, 64, 256)
WIDTHS = (1, 3, 5, 8, 32, 33)
LAMS = ((0, 0), (1, 2), (2, 0))
CASES = [(T, d, lam) for T in STRIPS for d in WIDTHS for lam in LAMS if T >> lam[0] >= 1]


def _dyadic(seed, B, L, d, dtype=torch.float64):
    x = np.random.default_rng(seed).integers(-8, 9, size=(B, L, d)) / 8.0
    return torch.from_numpy(x).to(dtype)


def _want(dx, dy, T, lam1, lam2):
    return kernel._refined_strips(stencil.delta_einsum("bid,bjd->bij", dx, dy), T, lam1, lam2)


def _unrefined(band, Lx, lam1, lam2):
    """The (B, Lx, Ly) Δ behind the mirror's refined, scaled entries."""
    return band[:, ::1 << lam1, ::1 << lam2][:, :Lx] * 2.0 ** (lam1 + lam2)


@pytest.mark.parametrize("T, d, lam", CASES,
                         ids=[f"T{T}-d{d}-lam{l1}{l2}" for T, d, (l1, l2) in CASES])
def test_band_assembles_to_the_einsum_exactly(T, d, lam):
    """Ly = 45 is no multiple of the band, every strip takes two bands or
    more, and ny < T from T = 64 on (at lam2 = 2, at T = 256): bands that
    start before the strip's first column and end past its last."""
    dx, dy = _dyadic(d, 2, 13, d), _dyadic(100 + d, 2, 45, d)
    got = kernel.fused_band_plain(dx, dy, T, *lam)
    assert torch.equal(got, _want(dx, dy, T, *lam))


@pytest.mark.parametrize("Lx, Ly", [(40, 7), (5, 60), (1, 1)])
@pytest.mark.parametrize("lam", [(0, 0), (1, 1), (0, 3), (3, 1)])
def test_band_assembles_at_other_shapes(Lx, Ly, lam):
    """Many strips over few columns, one strip over many bands, a single
    cell, and refinements that widen the tiles (lam = (3, 1): 10 tiles a
    row block) or narrow them (lam2 = 3: one tile)."""
    T = max(8, 1 << lam[0])
    dx, dy = _dyadic(7, 3, Lx, 6), _dyadic(8, 3, Ly, 6)
    assert torch.equal(kernel.fused_band_plain(dx, dy, T, *lam), _want(dx, dy, T, *lam))


def test_band_rounds_once_to_float32():
    """float32 increments: every band entry is the float64 dot product
    rounded once, as delta_einsum rounds it."""
    dx, dy = _dyadic(11, 2, 30, 33, torch.float32), _dyadic(12, 2, 25, 33, torch.float32)
    got = kernel.fused_band_plain(dx, dy, 16, 0, 0)
    assert got.dtype == torch.float32
    assert torch.equal(got, _want(dx, dy, 16, 0, 0))


def test_band_on_random_data_agrees_to_float64_rounding():
    dx = torch.from_numpy(np.random.default_rng(13).normal(size=(2, 50, 32)))
    dy = torch.from_numpy(np.random.default_rng(14).normal(size=(2, 40, 32)))
    got = kernel.fused_band_plain(dx, dy, 64, 1, 0)
    want = _want(dx, dy, 64, 1, 0)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-14


SOLVES = [(T, scheme, idt, lam) for T in (2, 16, 64)
          for scheme, idt in (("order1", "float32"), ("order2", "bfloat16"))
          for lam in ((0, 0), (1, 2)) if T >> lam[0] >= 1]


@pytest.mark.parametrize("T, scheme, idt, lam", SOLVES,
                         ids=[f"T{T}-{s}-{i}-lam{l1}{l2}" for T, s, i, (l1, l2) in SOLVES])
def test_solve_on_the_band_equals_solve_fused_plain_bitwise(T, scheme, idt, lam):
    dx, dy = _dyadic(21, 3, 19, 5, torch.float32), _dyadic(22, 3, 23, 5, torch.float32)
    band = kernel.fused_band_plain(dx, dy, T, *lam)
    got = kernel.solve_plain(_unrefined(band, 19, *lam), *lam, scheme, idt)
    assert torch.equal(got, kernel.solve_fused_plain(dx, dy, *lam, scheme, idt))


@pytest.mark.parametrize("scheme, lam", [("order1", (0, 0)), ("order2", (1, 1))])
def test_solve_on_the_band_matches_the_pallas_fused_kernel(scheme, lam):
    """The same Δ through the JAX package's fused Pallas kernel (interpret
    mode), which builds it with its own (R, d) x (d, Ly) products: float32
    tolerance of the other fused tests (5e-5)."""
    dx, dy = _dyadic(31, 3, 13, 4, torch.float32), _dyadic(32, 3, 11, 4, torch.float32)
    band = kernel.fused_band_plain(dx, dy, 16, *lam)
    got = kernel.solve_plain(_unrefined(band, 13, *lam), *lam, scheme, "float32")
    want = np.asarray(jops.solve_fused(jnp.asarray(dx.numpy()), jnp.asarray(dy.numpy()), *lam,
                                       None, scheme, "float32"), np.float64)
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert err <= 5e-5


@pytest.mark.parametrize("T, Ly, lam1, lam2, d, scheme", [
    (256, 1023, 0, 0, 32, "order1"), (64, 255, 0, 0, 8, "order1"),
    (16, 40, 1, 2, 33, "order2"), (2, 9, 0, 1, 1, "order2"), (512, 100, 3, 1, 5, "order1")])
def test_smem_bytes_is_the_layout(T, Ly, lam1, lam2, d, scheme):
    """kernel.smem_bytes (which choose_T reads) against the CUDA layout's
    pieces, all float32: staged dx rows, the dy ring, two bands, a band's
    new dy rows, the carried row(s) and three anti-diagonals."""
    g = kernel.band_geometry(T, lam1, lam2, d)
    R, m = T >> lam1, 1 << lam1
    rows = 2 if scheme == "order2" else 1
    layout = 4 * (g.RP * g.S + g.NR * g.S + 2 * R * g.BS + g.NY * d
                  + rows * ((Ly << lam2) + T + 1) + 3 * T)
    assert kernel.smem_bytes(True, scheme, T, Ly, lam1, lam2, d) == layout
    assert g.RP % 16 == 0 and g.RP >= R and g.S >= d + 4 and g.S % 8 == 4 and g.BS % 2 == 1
    # a row block's tiles cover its parallelogram, a band row its columns,
    # and the ring two consecutive bands' columns
    assert 8 * g.NT >= ((kernel.BAND + 16 * m - 2) >> lam2) + 2
    assert g.WB >= ((kernel.BAND + m - 2) >> lam2) + 2
    assert g.NR > ((kernel.BAND + (g.RP - 16) * m) >> lam2) + 8 * g.NT


def test_main_path_strips():
    """The main paths' fused strip heights: B4 at (128, 1023, 32) pairs and
    B3 at 128 x 128 pairs of (255, 8)."""
    assert ops.choose_T(1023, 1023, 0, 0, 128, d=32) == 256
    assert ops.choose_T(255, 255, 0, 0, 128 * 128, d=8) == 128
    assert ops.choose_T(255, 255, 0, 0, 128 * 128) == 64  # B1 keeps its strips
    assert ops.choose_T(1023, 1023, 0, 0, 8, d=8, max_t=1024) == kernel.FUSED_MAX_THREADS
