"""The port's Goursat-PDE wrappers against the JAX package's, and each CUDA
kernel against its plain PyTorch version.

On the CPU ``repro_torch.kernels.sigkernel_pde.ops`` runs the kernels' plain
versions; they are held against ``repro.kernels.sigkernel_pde.ops`` (the
Pallas kernels in interpret mode) on the same numpy inputs, and against the
JAX row-scan oracle in float64.  Errors are measured relative to the largest
value of the reference.  Tolerances: float32 5e-5 (the Pallas tier); float64
1e-10 (the same arithmetic); bf16 interiors 1e-2 (one bf16 rounding that
flips between two summation orders spreads through the grid).

Each kernel against its plain version on the card is in
``test_torch_kernels_gpu.py``, which imports no JAX.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import LaunchConfig as JaxLaunch
from repro.kernels.sigkernel_pde import ops as jops
from repro_torch.core.config import LaunchConfig
from repro_torch.core.sigkernel import solve_goursat, solve_goursat_antidiag
from repro_torch.kernels.sigkernel_pde import kernel, ops, ref

jsk = importlib.import_module("repro.core.sigkernel")

TOL = {"float32": 5e-5, "bfloat16": 1e-2}
COMBOS = [(scheme, idt, lam) for scheme in ("order1", "order2")
          for idt in ("float32", "bfloat16") for lam in ((0, 0), (1, 1))]
IDS = [f"{s}-{i}-lam{l1}{l2}" for s, i, (l1, l2) in COMBOS]


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def _rng(seed):
    return np.random.default_rng(seed)


def _delta(seed, B=3, Lx=13, Ly=11, dtype=np.float32):
    """Lx = 13 is no multiple of the JAX strip: it zero-pads."""
    return (_rng(seed).normal(size=(B, Lx, Ly)) * 0.3).astype(dtype)


def _incs(seed, B, L, d=4, dtype=np.float32):
    """Increments on a grid of 2^-6: every dot product of two rows is exact
    in float32, so both packages build the same Δ whatever their summation
    order, and the comparison isolates the solver."""
    x = np.round(_rng(seed).normal(size=(B, L, d)) * 0.3 * 64) / 64
    return x.astype(dtype)


@pytest.mark.parametrize("scheme, idt, lam", COMBOS, ids=IDS)
def test_solve_matches_pallas(scheme, idt, lam):
    d = _delta(0)
    want = jops.solve(jnp.asarray(d), *lam, None, scheme, idt)
    got = ops.solve(torch.from_numpy(d), *lam, None, scheme, idt)
    close(got, want, TOL[idt])


@pytest.mark.parametrize("scheme, idt, lam", COMBOS, ids=IDS)
def test_solve_fused_matches_pallas(scheme, idt, lam):
    dx, dy = _incs(1, 3, 13), _incs(2, 3, 11)
    want = jops.solve_fused(jnp.asarray(dx), jnp.asarray(dy), *lam, None, scheme, idt)
    got = ops.solve_fused(torch.from_numpy(dx), torch.from_numpy(dy), *lam, None,
                          scheme, idt)
    close(got, want, TOL[idt])


@pytest.mark.parametrize("scheme, idt, lam", COMBOS, ids=IDS)
def test_gram_fused_matches_pallas(scheme, idt, lam):
    dX, dY = _incs(3, 3, 13), _incs(4, 2, 11)
    want = jops.gram_fused(jnp.asarray(dX), jnp.asarray(dY), *lam, None, scheme, idt)
    got = ops.gram_fused(torch.from_numpy(dX), torch.from_numpy(dY), *lam, None,
                         scheme, idt)
    assert got.shape == (3, 2)
    close(got, want, TOL[idt])


def test_multi_strip_matches_pallas():
    """LaunchConfig(pde_strip=4): the JAX kernel sweeps 7 strips of 4 rows;
    the port's result does not depend on the strip."""
    d = _delta(5)
    want = jops.solve(jnp.asarray(d), 1, 1, JaxLaunch(pde_strip=4), "order2", "float32")
    got = ops.solve(torch.from_numpy(d), 1, 1, LaunchConfig(pde_strip=4), "order2",
                    "float32")
    close(got, want, TOL["float32"])


@pytest.mark.parametrize("scheme, idt, lam", COMBOS, ids=IDS)
def test_solve_float64_matches_jax_oracle(scheme, idt, lam):
    d = _delta(6, B=2, Lx=9, Ly=7, dtype=np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jsk.solve_goursat(jnp.asarray(d), *lam, scheme=scheme,
                                            interior_dtype=idt))
    got = ops.solve(torch.from_numpy(d), *lam, None, scheme, idt)
    assert got.dtype == torch.float64
    close(got, want, 1e-10)
    close(ref.solve(torch.from_numpy(d), *lam, scheme, idt), want, 1e-10)


def test_row_scan_grid_matches_jax_oracle():
    d = _delta(7, B=2, Lx=6, Ly=5, dtype=np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jsk.solve_goursat(jnp.asarray(d), 1, 0, return_grid=True,
                                            scheme="order2"))
    got = ref.solve_grid(torch.from_numpy(d), 1, 0, "order2")
    assert got.shape == (2, 13, 6)
    close(got, want, 1e-12)


@pytest.mark.parametrize("lam", [(0, 0), (2, 1), (1, 2)])
def test_antidiag_lane_transpose_and_chunking(lam):
    """nx > ny transposes the lanes; band_chunk splits the batch: neither
    changes a bit."""
    d = torch.from_numpy(_delta(8, B=5, Lx=12, Ly=4, dtype=np.float64))
    want = solve_goursat(d, *lam, scheme="order2")
    got = solve_goursat_antidiag(d, *lam, band_chunk=2, scheme="order2")
    close(got, want, 1e-13)


def test_float32_upcast_of_half_inputs():
    d = _delta(9)
    got = ops.solve(torch.from_numpy(d).to(torch.bfloat16))
    assert got.dtype == torch.float32
    want = ops.solve(torch.from_numpy(d).to(torch.bfloat16).float())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_batch_shape_is_kept():
    d = torch.from_numpy(_delta(10, B=6)).reshape(2, 3, 13, 11)
    assert ops.solve(d).shape == (2, 3)


# ---------------------------------------------------------------------------
# strip height and shared memory for the card (pure arithmetic)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Lx, Ly, lam1, lam2, n, d, scheme", [
    (1023, 1023, 0, 0, 128, 0, "order1"),
    (1023, 1023, 0, 0, 128, 32, "order1"),
    (255, 255, 0, 0, 128 * 128, 8, "order1"),
    (127, 127, 2, 0, 8, 8, "order2"),
    (5, 3, 1, 1, 4, 0, "order2"),
])
def test_choose_T_fits_one_block(Lx, Ly, lam1, lam2, n, d, scheme):
    T = ops.choose_T(Lx, Ly, lam1, lam2, n, d=d, scheme=scheme)
    kernel.check_strip(T, lam1, scheme)
    assert T % (1 << lam1) == 0
    assert kernel.smem_bytes(d > 0, scheme, T, Ly, lam1, lam2, d) <= kernel.SMEM_LIMIT
    assert T <= max(2, 1 << lam1, 1 << (Lx << lam1).bit_length())


@pytest.mark.parametrize("Lx, Ly, lam1, lam2, scheme", [
    (1023, 1023, 0, 0, "order1"), (1023, 1023, 0, 0, "order2"), (127, 127, 2, 0, "order2"),
    (4000, 4000, 0, 0, "order1"), (5, 3, 1, 1, "order2")])
def test_backward_strip_fits_one_block(Lx, Ly, lam1, lam2, scheme):
    """The one strip height of the checkpoint forward and the backward:
    both kernels' shared memory fits (the backward's two staged workspace
    groups and two dΔ tiles included), and every workspace row starts on
    16 bytes, as the backward's bulk copies need."""
    T = ops.choose_T(Lx, Ly, lam1, lam2, 128, scheme=scheme, backward=True)
    kernel.check_strip(T, lam1, scheme, kernel.BWD_MAX_THREADS)
    assert kernel.smem_bytes_bwd(scheme, T, Ly, lam1, lam2) <= kernel.SMEM_LIMIT
    assert kernel.smem_bytes(False, scheme, T, Ly, lam1, lam2) <= kernel.SMEM_LIMIT
    assert kernel.ws_stride(T) >= T and kernel.ws_stride(T) % 4 == 0
    if (Lx, Ly) == (1023, 1023):
        assert T == 512  # the gradient path's strip


def test_choose_T_respects_the_launch_cap():
    assert ops.choose_T(1023, 1023, 0, 0, 8, max_t=64) == 64
    assert ops.choose_T(1023, 1023, 0, 0, 8, max_t=1) == 2


def test_choose_T_raises_when_no_strip_fits():
    with pytest.raises(ValueError, match="shared memory"):
        ops.choose_T(64, 40000, 0, 0, 1, scheme="order2")


@pytest.mark.parametrize("T", [1, 3, 2048])
def test_check_strip_rejects_bad_heights(T):
    with pytest.raises(ValueError, match="pde_strip"):
        kernel.check_strip(T, 0, "order1")
