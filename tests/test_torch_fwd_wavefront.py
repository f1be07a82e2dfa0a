"""The precomputed-Δ forward's schedule and launch geometry, on the CPU.

``kernel.fwd_wavefront_plain`` runs the CUDA kernel's own schedule (R rows a
lane, the mbarrier rings that hand band edges from warp to warp, the
checkpoint rows written by the lanes that own them) in plain PyTorch.  It
must equal ``solve_plain`` (k) and ``solve_with_grid_plain`` (k and the
checkpoint rows) bit for bit for both stencils, both interior dtypes and
refined grids, at row counts around the lane and band boundaries and at
geometries that loop over bands; and the JAX package's Pallas forward
(interpret mode) within the float32 tolerance of the other port tests
(5e-5 relative; bf16 interiors 1e-2).  ``ops.geometry`` must fit every
launch shape of chip_smoke.py in one H100 block and cover all its rows.
The kernel itself against these on the card is in
``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import LaunchConfig as JaxLaunch
from repro.kernels.sigkernel_pde import ops as jops
from repro_torch.kernels.sigkernel_pde import kernel, ops

G = kernel.FwdGeometry
#: refined row counts at and around the lane (32) and band (256) boundaries
NX = (31, 32, 33, 255, 256, 257)
LAMS = ((0, 0), (1, 2), (2, 0))


def _delta(seed, B, Lx, Ly):
    d = np.random.default_rng(seed).normal(size=(B, Lx, Ly)) * 0.5 / np.sqrt(Lx)
    return torch.from_numpy(d.astype(np.float32))


def _Lx(nx, lam1):
    """Unrefined rows whose refined count is nx rounded up to 2^lam1."""
    return -(-nx // (1 << lam1))


def _other_geometry(i, nx):
    """A second geometry per case, cycling R and looping over bands where
    there are several (fewer warps than bands)."""
    R = kernel.FWD_ROWS[i % len(kernel.FWD_ROWS)]
    bands = kernel.fwd_bands(nx, R)
    return G(R, max(1, min(bands - 1, 3)) if bands > 1 else 1)


@pytest.mark.parametrize("scheme, idt", [("order1", "float32"), ("order2", "bfloat16")])
@pytest.mark.parametrize("lam", LAMS, ids=[f"lam{a}{b}" for a, b in LAMS])
@pytest.mark.parametrize("nx", NX)
def test_schedule_equals_solve_plain(nx, lam, scheme, idt):
    """k at the geometry ops.geometry picks and at a looping one."""
    Lx, Ly = _Lx(nx, lam[0]), 5
    delta = _delta(nx + 7 * lam[0] + lam[1], 3, Lx, Ly)
    want = kernel.solve_plain(delta, *lam, scheme, idt)
    for geo in (ops.geometry(Lx, Ly, *lam, scheme=scheme), _other_geometry(nx + lam[0], nx)):
        got = kernel.fwd_wavefront_plain(delta, geo, *lam, scheme, idt)
        assert torch.equal(got, want), (geo, float((got - want).abs().max()))


CPS_CASES = [(scheme, idt, lam) for scheme, idt, lam in
             (("order1", "float32", (0, 0)), ("order2", "bfloat16", (1, 2)),
              ("order2", "float32", (2, 0)), ("order1", "bfloat16", (0, 1)))]


@pytest.mark.parametrize("T", [2, 16, 64])
@pytest.mark.parametrize("scheme, idt, lam", CPS_CASES,
                         ids=[f"{s}-{i}-lam{a}{b}" for s, i, (a, b) in CPS_CASES])
@pytest.mark.parametrize("nx", NX)
def test_checkpoint_rows_equal_solve_with_grid_plain(nx, scheme, idt, lam, T):
    """k and every checkpoint row (the tails past ny included), written by
    the lanes that own rows sT-1 and sT-2, whatever the geometry's band
    height; at T = 2 and R = 2 every lane owns a checkpoint row."""
    if T < (1 << lam[0]):
        T = 1 << lam[0]
    Lx, Ly = _Lx(nx, lam[0]), 4
    delta = _delta(3 * nx + T, 2, Lx, Ly)
    k_want, cps_want = kernel.solve_with_grid_plain(delta, T, *lam, scheme, idt)
    geo = _other_geometry(nx + T, nx)
    k, cps = kernel.fwd_wavefront_plain(delta, geo, *lam, scheme, idt, T=T)
    assert torch.equal(k, k_want), geo
    assert torch.equal(cps, cps_want), (geo, float((cps - cps_want).abs().nan_to_num(1e30).max()))


@pytest.mark.parametrize("scheme, idt", [("order1", "float32"), ("order2", "float32"),
                                         ("order2", "bfloat16")])
def test_schedule_agrees_with_the_pallas_forward(scheme, idt):
    """The JAX package's Pallas forward (interpret mode) in its checkpoint
    mode, at the same strip height: k and the checkpoint rows."""
    lam, T = (1, 0), 8
    delta = _delta(5, 2, 13, 11)
    k, cps = kernel.fwd_wavefront_plain(delta, G(1, 1), *lam, scheme, idt, T=T)
    jk, jcps = jops.solve_with_grid(jnp.asarray(delta.numpy()), *lam, JaxLaunch(pde_strip=T),
                                    scheme, idt)
    tol = {"float32": 5e-5, "bfloat16": 1e-2}[idt]
    for got, want in ((k, jk), (cps, jcps)):
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape
        assert np.abs(got.double().numpy() - want).max() / np.abs(want).max() <= tol


def test_the_wrap_ring_holds_a_row(monkeypatch):
    """When a problem's warps loop over more bands than warps, the last warp
    hands its bottom row to the first warp's next band, which starts only
    after that warp's current band ends: with a ring of RING_SLOTS slots
    there the schedule deadlocks, with a whole row it completes."""
    delta = _delta(9, 1, 100, 300)
    want = kernel.solve_plain(delta, 0, 0, "order1", "float32")
    geo = G(1, 2)                                      # 4 bands, 2 warps
    assert torch.equal(kernel.fwd_wavefront_plain(delta, geo, 0, 0, "order1", "float32"), want)
    monkeypatch.setattr(kernel, "fwd_last_slots", lambda *a: kernel.RING_SLOTS)
    with pytest.raises(RuntimeError, match="deadlock"):
        kernel.fwd_wavefront_plain(delta, geo, 0, 0, "order1", "float32")


#: (problems, Lx, Ly, lam1, lam2, scheme, pde_strip) of every precomputed-Δ
#: forward chip_smoke.py launches: the forward and gradient paths' Δ
#: (sigkernel on (128, 1024, 32); Gram chunks of 255 x 255 and the trainer's
#: 64 x 64), the small card-vs-CPU input, and phase 6's kernel-vs-plain cases
SMOKE_SHAPES = (
    [(128, 1023, 1023, 0, 0, "order1", None), (64, 255, 255, 0, 0, "order1", None),
     (2048, 255, 255, 0, 0, "order1", None), (2080, 255, 255, 0, 0, "order1", None),
     (4096, 255, 255, 0, 0, "order1", None), (16384, 255, 255, 0, 0, "order1", None),
     (4, 63, 47, 0, 0, "order1", None)]
    + [(8, 127, 127, l1, l2, s, None) for s in ("order1", "order2")
       for l1, l2 in ((0, 0), (1, 1), (2, 0))]
    + [(8, 127, 127, 1, 1, "order2", 32), (8, 127, 63, 0, 0, "order1", 16),
       (8, 127, 63, 1, 0, "order2", None), (8, 23, 16, 0, 1, "order2", 2)])


@pytest.mark.parametrize("n, Lx, Ly, lam1, lam2, scheme, strip", SMOKE_SHAPES)
def test_geometry_fits_every_smoke_shape(n, Lx, Ly, lam1, lam2, scheme, strip):
    geo = ops.geometry(Lx, Ly, lam1, lam2, scheme=scheme, max_t=strip)
    kernel.check_fwd_geometry(geo, Lx, lam1)
    nx = Lx << lam1
    assert geo.R in kernel.FWD_ROWS
    assert 32 * geo.warps <= kernel.MAX_THREADS
    assert kernel.fwd_smem_bytes(scheme, geo, Lx, Ly, lam1, lam2) <= kernel.SMEM_LIMIT
    bands = kernel.fwd_bands(nx, geo.R)
    assert bands * 32 * geo.R >= nx > (bands - 1) * 32 * geo.R  # all rows, no empty band
    assert geo.warps <= bands
    if strip:
        assert 32 * geo.R * geo.warps <= max(32, strip)


def test_geometry_at_the_main_path_shapes():
    """The main paths' shapes take one pass of warps and R = _ROWS rows a
    lane; a problem of at most 32 rows one warp of one row a lane."""
    for L in (1023, 255, 63, 40):
        geo = ops.geometry(L, L)
        assert geo.R == ops._ROWS
        assert geo.warps == kernel.fwd_bands(L, geo.R)        # one pass, no loop
    assert ops.geometry(31, 40) == G(1, 1)


def test_geometry_honours_the_strip_cap():
    for strip in (2, 16, 32, 64, 256):
        geo = ops.geometry(1023, 1023, max_t=strip)
        assert 32 * geo.R * geo.warps <= max(32, strip)
    assert ops.geometry(1023, 1023, max_t=2) == G(1, 1)  # one warp of one row a lane


@pytest.mark.parametrize("geo, scheme, Lx, Ly", [
    (G(2, 16), "order1", 1023, 1023), (G(2, 4), "order2", 255, 255),
    (G(1, 1), "order1", 31, 40), (G(2, 3), "order2", 300, 70)])
def test_fwd_smem_bytes_is_the_layout(geo, scheme, Lx, Ly):
    """Full and empty mbarriers and CHUNK columns of the handed-over row(s)
    per ring slot (RING_SLOTS between two warps, a whole row from the last
    warp back to the first when the warps loop); per warp, STAGES staged
    chunks of R x CHUNK lines of STAGE_LINE floats; a chunk of ones."""
    rows = 2 if scheme == "order2" else 1
    loops = kernel.fwd_bands(Lx, geo.R) > geo.warps
    last = max(kernel.RING_SLOTS, -(-Ly // kernel.CHUNK)) if loops else 0
    slots = (geo.warps - 1) * kernel.RING_SLOTS + last
    want = (2 * kernel.CHUNK * 4 + slots * (2 * 8 + 4 * kernel.CHUNK * rows)
            + geo.warps * kernel.STAGES * geo.R * kernel.CHUNK * kernel.STAGE_LINE * 4)
    assert kernel.fwd_smem_bytes(scheme, geo, Lx, Ly, 0, 0) == want
