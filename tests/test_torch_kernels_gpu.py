"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

The Goursat kernels (``repro_torch/kernels/sigkernel_pde/csrc``) and the
Horner kernel (``repro_torch/kernels/signature/csrc``) have no CPU mode:
these tests need a CUDA card and skip without one.  The file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

The last tests drive the streaming ``Path``, ``coalesced_update``, the
feature maps (with draws made once and shared) and ``SigFeatureServer`` on
CUDA tensors, and hold them to the same calls on CPU tensors within the
float32 gates: 5e-5 for values, 2e-5 for gradients.
The sharded Gram runs on 1, 2 and 4 NCCL ranks, one a card
(``repro_torch.launch.spawn_ranks``), against the dense Gram on the card:
values 1e-6, gradients 1e-5 relative.  The example's reduced generator and
the reduced LM's train step run on the card against the same on the CPU.

Tolerances, relative to the largest plain value: float32 1e-4, bf16
interiors 2e-2.  (The kernels round each operation as the plain versions do
and form the fused dot products in float64, so in practice they agree
exactly; the tolerances leave room for a dot product that lands within
1e-16 of a float32 rounding boundary.)  The checkpoint rows must agree
exactly; the backward kernel, whose dyadic fold sums in another order than
its plain version, is held to 1e-4 for both interior dtypes (its adjoint
stays float32 throughout).  The Horner kernel rounds every operation as its
plain version does and divides truly, so it must match it exactly, across
launch settings too.
"""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.config import LaunchConfig
from repro_torch.core.tensoralg import sig_dim
from repro_torch.kernels.sigkernel_pde import kernel, ops
from repro_torch.kernels.signature import kernel as sig_kernel
from repro_torch.kernels.signature import ops as sig_ops
from repro_torch.kernels.signature import ref as sig_ref

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
@pytest.mark.parametrize("strip", [None, 16], ids=["auto_strip", "strip16"])
@pytest.mark.parametrize("scheme, idt, lam", COMBOS, ids=IDS)
def test_cps_and_bwd_match_plain(cuda, scheme, idt, lam, strip):
    """fwd_cps (k and checkpoint rows) and bwd against solve_with_grid_plain
    and solve_grad_plain; Lx = 44 is no multiple of the strip and nx > ny."""
    delta = torch.einsum("bid,bjd->bij", _incs(4, 3, 45, 5, cuda), _incs(5, 3, 30, 5, cuda))
    gbar = _incs(6, 1, 1, 3, cuda).reshape(3)
    T = ops.choose_T(44, 29, *lam, 3, scheme=scheme, max_t=strip)
    before = (kernel.fwd_cps.launches, kernel.bwd.launches)
    k, cps = kernel.fwd_cps(delta, T, *lam, scheme, idt,
                            ops.geometry(*delta.shape[1:], *lam, scheme=scheme, T=T))
    dd = kernel.bwd(delta, cps, gbar, T, *lam, scheme, idt)
    assert (kernel.fwd_cps.launches, kernel.bwd.launches) == (before[0] + 1, before[1] + 1)
    k_plain, cps_plain = kernel.solve_with_grid_plain(delta, T, *lam, scheme, idt)
    _close(k, k_plain, TOL[idt])
    torch.testing.assert_close(cps, cps_plain, rtol=0, atol=0)
    _close(dd, kernel.solve_grad_plain(delta, cps_plain, gbar, T, *lam, scheme, idt), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["order1", "order2"])
def test_bwd_two_row_strips(cuda, scheme):
    """T = 2: lane 0 writes the carried products lane 1 reads in the same step."""
    delta = torch.einsum("bid,bjd->bij", _incs(7, 3, 9, 3, cuda), _incs(8, 3, 12, 3, cuda))
    gbar = torch.ones(3, device=cuda)
    k, cps = kernel.fwd_cps(delta, 2, 0, 1, scheme, "float32",
                            ops.geometry(9, 12, 0, 1, scheme=scheme, T=2))
    dd = kernel.bwd(delta, cps, gbar, 2, 0, 1, scheme, "float32")
    _, cps_plain = kernel.solve_with_grid_plain(delta, 2, 0, 1, scheme, "float32")
    torch.testing.assert_close(cps, cps_plain, rtol=0, atol=0)
    _close(dd, kernel.solve_grad_plain(delta, cps, gbar, 2, 0, 1, scheme, "float32"), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("strip", [2, 8, 64])
def test_solve_grad_strips_line_up(cuda, strip):
    """A LaunchConfig.pde_strip cap sets one T for the checkpoint forward and
    the backward: the card's gradient equals the CPU's plain one."""
    delta = torch.einsum("bid,bjd->bij", _incs(9, 4, 40, 4, cuda), _incs(10, 4, 33, 4, cuda))
    launch = LaunchConfig(pde_strip=strip)
    got = delta.clone().requires_grad_()
    ops.solve(got, 1, 0, launch, "order2").sum().backward()
    want = delta.cpu().requires_grad_()
    ops.solve(want, 1, 0, launch, "order2").sum().backward()
    _close(got.grad, want.grad.to(cuda), 1e-4)


@pytest.mark.gpu
def test_streaming_mmd2_backward_holds_less_memory(cuda):
    """mmd2(row_block=...) streams its Gram sums under checkpointing: its
    backward's peak memory stays below the dense Grams' backward."""
    X = _incs(11, 48, 64, 3, cuda).cumsum(1)
    Y = _incs(12, 48, 64, 3, cuda).cumsum(1)

    def peak(**kw):
        Xg = X.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rt.mmd2(Xg, Y, **kw).backward()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, Xg.grad

    dense, g_dense = peak()
    streamed, g_stream = peak(row_block=4)
    _close(g_stream, g_dense, 1e-4)
    assert streamed < dense, (streamed, dense)


@pytest.mark.gpu
def test_two_row_strips(cuda):
    """T = 2: row 1 overwrites the carried entry row 0 reads in the same step."""
    delta = torch.einsum("bid,bjd->bij", _incs(2, 3, 9, 3, cuda), _incs(3, 3, 12, 3, cuda))
    for scheme in ("order1", "order2"):
        got = ops.solve(delta, 0, 1, LaunchConfig(pde_strip=2), scheme)
        _close(got, kernel.solve_plain(delta, 0, 1, scheme, "float32"), TOL["float32"])


FUSED_COMBOS = [("order1", "float32", (0, 0)), ("order2", "bfloat16", (1, 1)),
                ("order1", "float32", (2, 0))]


@pytest.mark.gpu
@pytest.mark.parametrize("strip", [2, 4, 16])
@pytest.mark.parametrize("d", [1, 8, 32, 33])
@pytest.mark.parametrize("scheme, idt, lam", FUSED_COMBOS,
                         ids=[f"{s}-{i}-lam{l1}{l2}" for s, i, (l1, l2) in FUSED_COMBOS])
@pytest.mark.parametrize("which", ["fwd_fused", "gram_fused"])
def test_fused_band_widths_and_short_strips(cuda, which, scheme, idt, lam, d, strip):
    """The fused kernels' Δ band: tile products over every k padding (d = 1,
    8, 32, 33 pad to 4, 8, 32, 36) and strips of fewer than 32 rows, where the
    lanes at or past T only build tiles (lam1 = 2 raises strip 2 to 4)."""
    dx, dy = _incs(20 + d, 3, 45, d, cuda), _incs(40 + d, 3, 30, d, cuda)
    launch = LaunchConfig(pde_strip=strip)
    if which == "fwd_fused":
        got = ops.solve_fused(dx, dy, *lam, launch, scheme, idt)
        want = kernel.solve_fused_plain(dx, dy, *lam, scheme, idt)
    else:
        got = ops.gram_fused(dx, dy, *lam, launch, scheme, idt)
        want = kernel.gram_fused_plain(dx, dy, *lam, scheme, idt)
    _close(got, want, TOL[idt])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["fwd_fused", "gram_fused"])
def test_fused_kernels_mid_size(cuda, which, record_property):
    """B4 on (8, 300, 32) x (8, 280, 32) pairs and B3 as a 16 x 16 Gram of
    (200, 8) increments, at the wrappers' strip height; the largest absolute
    difference from the plain version is reported."""
    if which == "fwd_fused":
        dx, dy = _incs(60, 8, 300, 32, cuda), _incs(61, 8, 280, 32, cuda)
        got = ops.solve_fused(dx, dy)
        want = kernel.solve_fused_plain(dx, dy, 0, 0, "order1", "float32")
    else:
        dx, dy = _incs(62, 16, 200, 8, cuda), _incs(63, 16, 200, 8, cuda)
        got = ops.gram_fused(dx, dy)
        want = kernel.gram_fused_plain(dx, dy, 0, 0, "order1", "float32")
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    record_property("max_abs_err", max_abs)
    print(f"{which}: max abs err {max_abs:.3g}")
    _close(got, want, TOL["float32"])


@pytest.mark.gpu
def test_smem_bytes_mirrors_the_cuda_layout(cuda):
    """kernel.smem_bytes (which choose_T reads) equals the CUDA source's
    smem_bytes, which the fused launches check, and kernel.fwd_smem_bytes
    (which ops.geometry reads) the source's wave_smem_bytes at every
    geometry: R rows a lane, one or several warps, one pass or a loop over
    bands (the wrap ring)."""
    lib = kernel.library()
    for T in (2, 4, 16, 32, 64, 256, 512):
        for lam1, lam2 in ((0, 0), (1, 2), (2, 0), (0, 3)):
            if T >> lam1 < 1:
                continue
            for scheme in ("order1", "order2"):
                for d in (1, 8, 32, 33):
                    want = lib.sigkernel_pde_smem_bytes(scheme == "order2", T, 255, lam1,
                                                        lam2, d)
                    assert kernel.smem_bytes(scheme, T, 255, lam1, lam2, d) == want
    for R in kernel.FWD_ROWS:
        for warps in (1, 2, 3, 8, 16):
            for Lx, Ly, lam1, lam2 in ((255, 255, 0, 0), (1023, 1023, 0, 0), (100, 300, 1, 2)):
                for scheme in ("order1", "order2"):
                    geo = kernel.FwdGeometry(R, warps)
                    want = lib.sigkernel_pde_fwd_smem_bytes(scheme == "order2", R, warps, Lx,
                                                            Ly, lam1, lam2)
                    assert kernel.fwd_smem_bytes(scheme, geo, Lx, Ly, lam1, lam2) == want


#: (nx, scheme, interior dtype, (lam1, lam2), checkpoint strip T)
WAVE_CASES = ([(nx, "order1", "float32", (0, 0), 64) for nx in (31, 32, 33, 255, 256, 257, 1023)]
              + [(nx, "order2", "bfloat16", (0, 0), 16) for nx in (33, 257, 1023)]
              + [(257, "order2", "float32", (0, 0), 2), (256, "order1", "float32", (2, 0), 4),
                 (260, "order2", "bfloat16", (2, 1), 8)])


@pytest.mark.gpu
@pytest.mark.parametrize("nx, scheme, idt, lam, T", WAVE_CASES,
                         ids=[f"nx{n}-{s}-{i}-lam{a}{b}-T{T}" for n, s, i, (a, b), T in WAVE_CASES])
def test_wavefront_geometries_match_plain(cuda, nx, scheme, idt, lam, T):
    """The register-wavefront forward at every R the geometry can pick (one
    pass of warps and a loop of one warp over the bands), both modes,
    against solve_plain and solve_with_grid_plain exactly (k and the
    checkpoint rows); the backward on those checkpoint rows against
    solve_grad_plain (1e-4, its fold's order)."""
    Lx, Ly = nx >> lam[0], 40
    delta = torch.einsum("bid,bjd->bij", _incs(70 + nx, 3, Lx + 1, 4, cuda),
                         _incs(71 + nx, 3, Ly + 1, 4, cuda))
    k_plain = kernel.solve_plain(delta, *lam, scheme, idt)
    kg, cps_plain = kernel.solve_with_grid_plain(delta, T, *lam, scheme, idt)
    gbar = _incs(72, 1, 1, 3, cuda).reshape(3)
    dd_plain = kernel.solve_grad_plain(delta, cps_plain, gbar, T, *lam, scheme, idt)
    torch.testing.assert_close(kg, k_plain, rtol=0, atol=0)
    for R in kernel.FWD_ROWS:
        bands = kernel.fwd_bands(nx, R)
        for geo in {kernel.FwdGeometry(R, min(bands, kernel.MAX_THREADS // 32)),
                    kernel.FwdGeometry(R, 1)}:
            assert torch.equal(kernel.fwd(delta, geo, *lam, scheme, idt), k_plain), geo
            if R > T:
                continue
            k, cps = kernel.fwd_cps(delta, T, *lam, scheme, idt, geo)
            assert torch.equal(k, k_plain), geo
            assert torch.equal(cps, cps_plain), geo
            _close(kernel.bwd(delta, cps, gbar, T, *lam, scheme, idt), dd_plain, 1e-4)


@pytest.mark.gpu
def test_launcher_checks_its_inputs(cuda):
    delta = torch.zeros(2, 5, 5, device=cuda)
    geo = ops.geometry(5, 5)
    with pytest.raises(TypeError, match="float32"):
        kernel.fwd(delta.double(), geo, 0, 0, "order1", "float32")
    with pytest.raises(ValueError, match="contiguous"):
        kernel.fwd(delta.transpose(1, 2), geo, 0, 0, "order1", "float32")
    with pytest.raises(ValueError, match="geometry"):
        kernel.fwd(delta, kernel.FwdGeometry(3, 1), 0, 0, "order1", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.fwd(delta.cpu(), geo, 0, 0, "order1", "float32")


# ---------------------------------------------------------------------------
# the Horner kernel (B5)
# ---------------------------------------------------------------------------

#: (d, N) of the sweep: d in {1, 2, 3, 4, 8, 9, 16}, N in 1..6 (d = 9 is
#: time-aug + lead-lag of 4 channels)
HORNER_SHAPES = [(d, N) for d in (1, 2, 3, 4, 8, 9, 16) for N in range(1, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("d, N", HORNER_SHAPES, ids=[f"d{d}-N{N}" for d, N in HORNER_SHAPES])
def test_horner_matches_plain_exactly(cuda, d, N):
    """B = 3 paths of 12 increments (one at d = 16, N = 6, whose signature
    has 17.9 M entries); length blocks of 4 leave a partial one."""
    z = _incs(20, 3, 2 if (d, N) == (16, 6) else 13, d, cuda)
    before = sig_kernel.horner.launches
    got = sig_ops.signature_from_increments(z, N)
    assert sig_kernel.horner.launches == before + 1
    want = sig_kernel.horner_plain(z, N)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    short = sig_ops.signature_from_increments(z, N, LaunchConfig(sig_lb=4, sig_bt=32))
    assert torch.equal(short, got)


@pytest.mark.gpu
@pytest.mark.parametrize("B, L", [(1, 2), (5, 2), (7, 70), (129, 9)])
def test_horner_ragged_edges(cuda, B, L):
    """L = 2 (one increment), L - 1 not a multiple of the length block, an
    odd batch; zero increments appended change no bit."""
    z = _incs(21, B, L, 3, cuda)
    got = sig_ops.signature_from_increments(z, 4, LaunchConfig(sig_lb=16))
    torch.cuda.synchronize()
    assert torch.equal(got, sig_kernel.horner_plain(z, 4))
    padded = torch.cat([z, torch.zeros(B, 5, 3, device=cuda)], dim=1)
    assert torch.equal(sig_ops.signature_from_increments(padded, 4), got)


@pytest.mark.gpu
def test_horner_bf16_and_oracle(cuda):
    z = _incs(22, 4, 20, 3, cuda)
    zb = z.to(torch.bfloat16)
    got = sig_ops.signature_from_increments(zb, 4)
    assert got.dtype == torch.bfloat16
    want = sig_kernel.horner_plain(zb.float(), 4)
    assert torch.equal(got, want.to(torch.bfloat16))
    _close(sig_ops.signature_from_increments(z, 4), sig_ref.signature_from_increments(z, 4),
           1e-5)


@pytest.mark.gpu
def test_signature_card_matches_cpu(cuda):
    x = _incs(23, 3, 30, 2, cuda).cumsum(1)
    lengths = torch.tensor([30, 4, 17])
    tf = rt.TransformPipeline(time_aug=True, lead_lag=True)
    for mode in ("lyndon", "brackets", "expand"):
        got = rt.logsignature(x, 3, mode=mode, transforms=tf, lengths=lengths)
        want = rt.logsignature(x.cpu(), 3, mode=mode, transforms=tf, lengths=lengths)
        _close(got.cpu(), want, 1e-5)
    xg = x.clone().requires_grad_()
    rt.signature(xg, 4, transforms=tf).sum().backward()
    xc = x.cpu().requires_grad_()
    rt.signature(xc, 4, transforms=tf).sum().backward()
    _close(xg.grad.cpu(), xc.grad, 1e-4)


@pytest.mark.gpu
def test_paper_depth_lead_lag_signature_on_the_card(cuda):
    """Time-aug + lead-lag of 4 channels (d' = 9) at the paper's depth 6 and
    d = 16 at depth 5 go through the kernel with the default backend and
    equal the CPU's plain scan."""
    tf = rt.TransformPipeline(time_aug=True, lead_lag=True)
    for x, N, kw in ((_incs(25, 4, 40, 4, cuda).cumsum(1), 6, {"transforms": tf}),
                     (_incs(26, 2, 9, 16, cuda).cumsum(1), 5, {})):
        before = sig_kernel.horner.launches
        got = rt.signature(x, N, **kw)
        assert sig_kernel.horner.launches == before + 1
        want = rt.signature(x.cpu(), N, **kw)
        _close(got.cpu(), want, 1e-5)
        _close(rt.logsignature(x, N, **kw).cpu(), rt.logsignature(x.cpu(), N, **kw), 1e-5)


@pytest.mark.gpu
def test_signature_backward_memory_is_flat_in_length(cuda):
    """The §2.4 backward keeps O(1) signatures in L: above the increments and
    their gradient, its peak stays at a few (B, sig_dim) buffers, the same
    for a path twice as long."""
    B, d, N = 16, 4, 4
    sd = sig_dim(d, N)

    def extra(L):
        z = _incs(24, B, L, d, cuda).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sig_ops.signature_from_increments(z, N).sum().backward()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base - 2 * z.numel() * 4

    short, long_ = extra(200), extra(400)
    assert long_ < 1.25 * short + (1 << 20), (short, long_)
    assert long_ < 64 * B * sd * 4, (long_, B * sd * 4)


@pytest.mark.gpu
def test_horner_launcher_checks_its_inputs(cuda):
    z = torch.zeros(2, 5, 3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        sig_kernel.horner(z.double(), 3, 1, 3, 1, 4, 32)
    with pytest.raises(ValueError, match="contiguous"):
        sig_kernel.horner(z.transpose(1, 2), 3, 1, 3, 1, 4, 32)
    with pytest.raises(ValueError, match="threads"):
        sig_kernel.horner(z, 3, 1, 3, 1, 4, 48)
    with pytest.raises(ValueError, match="geometry"):
        sig_kernel.horner(z, 3, 3, 3, 1, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        sig_kernel.horner(z.cpu(), 3, 1, 3, 1, 4, 32)
    with pytest.raises(ValueError, match="stream=True"):
        rt.signature(z, 3, stream=True, backend="gpu")


# ---------------------------------------------------------------------------
# the streaming Path, the feature maps and the server: card against CPU
# ---------------------------------------------------------------------------

def _points(seed, *shape, scale=0.3):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(x.astype(np.float32))


def _rel(got, want):
    torch.cuda.synchronize()
    got, want = got.detach().cpu(), want.detach().cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("lead_lag", [False, True], ids=["plain", "lead_lag"])
def test_path_on_the_card_matches_cpu(cuda, lead_lag):
    from repro_torch.stream import Path
    tp = rt.TransformPipeline(lead_lag=lead_lag)
    x, more = _points(0, 3, 37, 3), _points(1, 3, 5, 3)
    on = {dev: Path.from_points(x.to(dev), 4, transforms=tp) for dev in ("cpu", cuda)}
    assert on[cuda].prefix.is_cuda
    for q in (lambda p: p.signature(), lambda p: p.signature(0, 20),
              lambda p: p.signature(3, 31), lambda p: p.rolling(8, stride=3),
              lambda p: p.logsignature(2, 30),
              lambda p: p.update(more.to(p.points.device)).signature(30, 42),
              lambda p: p.evict(before=9).signature(),
              lambda p: p.update(more.to(p.points.device)).evict(before=12).signature(2, 20)):
        assert _rel(q(on[cuda]), q(on["cpu"])) <= 5e-5
    # against a fresh signature on the card (the Horner kernel)
    before = sig_kernel.horner.launches
    fresh = rt.signature(x.to(cuda), 4, transforms=tp)
    assert sig_kernel.horner.launches == before + 1
    assert _rel(on[cuda].signature(), fresh) <= 5e-5


@pytest.mark.gpu
def test_coalesced_update_and_retention_on_the_card(cuda):
    from repro_torch.stream import Path, coalesced_update
    xs = [_points(10 + i, 9 + i, 2) for i in range(3)]
    chunks = [_points(20 + i, 1 + i, 2) for i in range(3)]
    out = {dev: coalesced_update([Path.from_points(x.to(dev), 3, retention=11) for x in xs],
                                 [c.to(dev) for c in chunks]) for dev in ("cpu", cuda)}
    for a, b in zip(out[cuda], out["cpu"]):
        assert len(a) == len(b) and a.prefix.is_cuda
        assert _rel(a.signature(), b.signature()) <= 5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("lift", ["linear", "rbf"])
def test_rff_features_on_the_card_match_cpu(cuda, lift):
    from repro_torch.core import features as ft
    kern = rt.Linear() if lift == "linear" else rt.RBF(0.8)
    f = rt.FeatureConfig("rff", rank=32, depth=4, lift_dim=32)
    draws = ft.rff_draws(f, kern, 3, dtype=torch.float32, device="cpu")
    on_card = ft.RFFDraws(*(None if v is None else v.to(cuda) for v in
                            (draws.w, draws.b, draws.proj)))
    X = _points(30, 6, 40, 3)
    got = {}
    for dev, dr in (("cpu", draws), (cuda, on_card)):
        leaf = X.to(dev).requires_grad_()
        phi = ft.rff_features(leaf, f, rt.TransformPipeline(), kern, draws=dr)
        got[dev] = (phi, torch.autograd.grad((phi @ phi.T).sum(), leaf)[0])
    assert _rel(got[cuda][0], got["cpu"][0]) <= 5e-5
    assert _rel(got[cuda][1], got["cpu"][1]) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("lift", ["linear", "rbf"])
def test_nystroem_on_the_card_matches_cpu(cuda, lift):
    """The same pool through the Goursat kernels (card) and the plain
    solvers (CPU); the pool and cross Grams launch B3 (linear) or B1."""
    from repro_torch.core import gram as tgram
    kern = rt.Linear() if lift == "linear" else rt.RBF(1.0)
    f = rt.FeatureConfig("nystroem", rank=3)
    X, Y = _points(40, 8, 33, 3), _points(41, 5, 29, 3)
    pool = torch.randperm(8, generator=torch.Generator().manual_seed(0))
    launcher = kernel.gram_fused if lift == "linear" else kernel.fwd
    products = {}
    for dev in ("cpu", cuda):
        backend = tgram.dispatch.resolve("auto", op="gram", device=dev,
                                         allow_fused=kern.lifts_increments)
        prep = [tgram._prepare(v.to(dev), rt.TransformPipeline(), kern) for v in (X, Y)]
        before = launcher.launches
        phiX, phiY = tgram._nystroem_maps(*prep, f, kern, backend, rt.GridConfig(),
                                          rt.LaunchConfig(), pool_idx=pool.to(dev))
        if dev == cuda:
            assert launcher.launches > before
        products[dev] = phiX @ phiY.T
    assert _rel(products[cuda], products["cpu"]) <= 5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["rff", "nystroem"])
def test_feature_losses_on_the_card(cuda, method):
    from repro_torch.core.losses import sig_aux_loss
    f = rt.FeatureConfig(method, rank=4)
    X, Y = _points(50, 12, 33, 3).to(cuda), _points(51, 10, 33, 3).to(cuda)
    leaf = X.clone().requires_grad_()
    (g,) = torch.autograd.grad(rt.mmd2(leaf, Y, features=f), leaf)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    H, P = _points(52, 12, 33, 16).to(cuda), _points(53, 16, 3).to(cuda)
    assert bool(torch.isfinite(sig_aux_loss(H, Y, proj=P, features=f)))
    with pytest.raises(ValueError, match="approximate=True"):
        rt.sigkernel_gram(X, Y, backend=method)


@pytest.mark.gpu
def test_server_on_the_card_matches_cpu(cuda):
    from repro_torch.core import features as ft
    from repro_torch.serve import SigFeatureServer
    f = rt.FeatureConfig("rff", rank=8, depth=3)
    srv = {dev: SigFeatureServer(3, features=f, device=dev) for dev in ("cpu", None)}
    assert srv[None].device.type == "cuda"
    for i in range(5):
        for s in srv.values():
            s.open_stream(f"s{i}", _points(60 + i, 12 + 3 * i, 2))
    for rnd in range(3):
        for i in range(5):
            for s in srv.values():
                s.append(f"s{i}", _points(70 + 10 * rnd + i, 1 + (i + rnd) % 4, 2))
        assert srv[None].flush() == srv["cpu"].flush() == 5
    for i in range(5):
        assert _rel(srv[None].signature(f"s{i}"), srv["cpu"].signature(f"s{i}")) <= 5e-5
        assert _rel(srv[None].rolling(f"s{i}", 5), srv["cpu"].rolling(f"s{i}", 5)) <= 5e-5
        p = srv[None].path(f"s{i}")
        want = ft.rff_features(p.points[len(p) - 6:len(p)][None], f, srv[None].transforms,
                               srv[None].static_kernel)[0]
        assert torch.equal(srv[None].features(f"s{i}", window=6), want)
    st_card, st_cpu = srv[None].stats(), srv["cpu"].stats()
    for k in ("update_groups", "solo_updates", "coalesced_streams", "flushes"):
        assert st_card[k] == st_cpu[k]


@pytest.mark.gpu
def test_fused_gram_gradient_does_not_depend_on_the_row_block(cuda):
    """A row's gradient through the fused Gram is the same whether it is
    solved with all rows or in blocks (as a sharded tile is): one dot
    product a pair, the sum over the columns in float64 (1e-6 relative; a
    single float32 GEMM over all columns missed 1e-5 at 64 of 128 rows)."""
    X = torch.cumsum(_incs(40, 128, 256, 8, cuda), dim=1)
    Y = torch.cumsum(_incs(41, 128, 256, 8, cuda), dim=1)
    W = torch.from_numpy(np.random.default_rng(42).normal(size=(128, 128))
                         .astype(np.float32)).to(cuda)

    def grad_x(**kw):
        a = X.clone().requires_grad_()
        return torch.autograd.grad((rt.sigkernel_gram(a, Y, **kw) * W).sum(), a)[0]

    full = grad_x()
    for rb in (64, 32):
        _close(grad_x(row_block=rb), full, 1e-6)


#: the sharded Gram's cases on the card (tests/torch_sharded_ranks.py)
NCCL_CASES = ("linear", "linear_sym", "ragged", "rbf", "rbf_sym")


@pytest.mark.gpu
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_gram_on_nccl_equals_dense(cuda, world):
    """1, 2 and 4 NCCL ranks, one a card (skipped without the cards): every
    rank's sharded Gram and its gradient against the dense ones on that card
    (values 1e-6, gradients 1e-5 relative)."""
    import torch_sharded_ranks as ranks
    from repro_torch.launch import spawn_ranks
    if world > torch.cuda.device_count():
        pytest.skip(f"needs {world} cards, the host has {torch.cuda.device_count()}")
    outs = spawn_ranks(ranks.nccl_rank, world, (NCCL_CASES,), backend="nccl", timeout=600)
    for o in outs:
        for case in NCCL_CASES:
            _close(o[case]["sharded"], o[case]["dense"], 1e-6)
            _close(o[case]["sharded_grads"]["X"], o[case]["dense_grads"]["X"], 1e-5)


@pytest.mark.gpu
def test_nccl_refuses_more_ranks_than_cards(cuda):
    import torch_sharded_ranks as ranks
    from repro_torch.launch import spawn_ranks
    with pytest.raises(ValueError, match="more ranks than cards"):
        spawn_ranks(ranks.nccl_rank, torch.cuda.device_count() + 1, (NCCL_CASES,),
                    backend="nccl")


def _gan_example():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "train_sigkernel_gan_torch.py")
    spec = importlib.util.spec_from_file_location("train_sigkernel_gan_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("dyadic", [0, 1])
def test_generator_on_the_card_matches_cpu(cuda, dyadic):
    """The example's reduced generator under its loss (time-aug, (λ, λ) =
    (dyadic, dyadic)): the MMD² and every parameter gradient on the card
    against the CPU's, one set of weights (1e-4 relative)."""
    import copy
    ex = _gan_example()
    gen = ex.build_generator(ex.generator_config(False), 3, ex.NOISE_DIM, device="cpu")
    gen_card = copy.deepcopy(gen).to(cuda)
    g = torch.Generator().manual_seed(0)
    noise = torch.randn((6, 20, ex.NOISE_DIM), generator=g)
    real = torch.cumsum(torch.randn((6, 20, 3), generator=g) * 0.1, dim=1)
    out = []
    for m, dev in ((gen_card, cuda), (gen, torch.device("cpu"))):
        v = rt.mmd2(m(noise.to(dev)), real.to(dev), **ex.kernel_spec(dyadic))
        out.append((v, torch.autograd.grad(v, list(m.parameters()))))
    (v_card, g_card), (v_cpu, g_cpu) = out
    _close(v_card.detach().cpu(), v_cpu.detach(), 1e-4)
    for a, b in zip(g_card, g_cpu):
        _close(a.cpu(), b, 1e-4)


@pytest.mark.gpu
def test_lm_train_step_on_the_card_matches_cpu(cuda):
    """One step of the reduced deepseek-7b LM with its signature-kernel
    auxiliary loss (float32 compute, two microbatches), one set of weights
    and one batch: the metrics (5e-5) and the averaged gradients the step
    hands the optimizer (2e-4 norm-relative) on the card against the CPU."""
    import copy
    from repro_torch.data import TokenLM
    from repro_torch.models import build_model, get_config
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step
    cfg = get_config("deepseek-7b").reduced().replace(sig_loss=True)
    model = build_model(cfg, device="cpu")
    model_card = copy.deepcopy(model).to(cuda)
    batch = TokenLM(vocab=cfg.vocab, seq=16, batch=4, sig_target_dim=4,
                    device="cpu").batch_at(0)
    mets = []
    for m, dev in ((model_card, cuda), (model, torch.device("cpu"))):
        step = make_train_step(m, AdamW(m.parameters(), lr=cosine_schedule(1e-3, 2, 50)),
                               num_microbatches=2)
        mets.append(step({k: v.to(dev) for k, v in batch.items()}))
    for k, want in mets[1].items():     # "aux" is 0 on both
        assert abs(float(mets[0][k]) - float(want)) <= 5e-5 * abs(float(want)), k
    for (name, p), q in zip(model.named_parameters(), model_card.parameters()):
        err = float((q.grad.cpu() - p.grad).norm() / p.grad.norm().clamp_min(1e-30))
        assert err <= 2e-4, f"{name}: {err:.3g}"


@pytest.mark.gpu
def test_token_stream_on_the_card(cuda):
    """TokenLM draws on the card by default: one (seed, step), one batch."""
    from repro_torch.data import TokenLM
    d = TokenLM(vocab=102400, seq=64, batch=4, sig_target_dim=4)
    a, b = d.batch_at(3), d.batch_at(3)
    assert a["tokens"].is_cuda and a["sig_target"].is_cuda
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 102400


@pytest.mark.gpu
@pytest.mark.parametrize("largest", [1.3728498, 3.846831, 1.0])
def test_int8_quantisation_on_the_card_equals_the_cpu(cuda, largest):
    """quantize_int8 / dequantize bit for bit across devices.  The first two
    largest magnitudes are ones whose scale differs in its last bit where
    max|x| / 127 is taken as a product with the reciprocal of 127, which a
    Python-number divisor becomes on the card."""
    from repro_torch.optim import dequantize, quantize_int8
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, size=(513, 7))
                         .astype(np.float32))
    x[0, 0] = largest
    q, s = quantize_int8(x)
    qc, sc = quantize_int8(x.to(cuda))
    assert torch.equal(qc.cpu(), q)
    assert sc.cpu().view(torch.int32).item() == s.view(torch.int32).item()
    assert torch.equal(dequantize(qc, sc).cpu().view(torch.int32),
                       dequantize(q, s).view(torch.int32))


# ---------------------------------------------------------------------------
# the Goursat ops and the streaming guard on the card
# ---------------------------------------------------------------------------

def _op_cases(device):
    """Each Goursat kernel's op and the arguments of one small call on the
    card (the geometry and strip heights its wrapper would pick)."""
    g = torch.Generator().manual_seed(3)

    def r(*shape, scale=0.1):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    delta, dx, dy = r(3, 20, 17), r(3, 20, 4, scale=0.3), r(3, 17, 4, scale=0.3)
    s2, T = (1, 0, "order2", "float32"), 8
    geo = tuple(ops.geometry(20, 17, 1, 0, scheme="order2", T=T))
    _, cps = ops.goursat_fwd_cps(delta, T, *geo, *s2)
    return {
        "goursat_fwd": (delta, *ops.geometry(20, 17, 1, 0, scheme="order2"), *s2),
        "goursat_fwd_cps": (delta, T, *geo, *s2),
        "goursat_bwd": (delta, cps, r(3, scale=1.0), T, *s2),
        "goursat_fwd_fused": (dx, dy, ops.choose_T(20, 17, 0, 0, 3, d=4), 0, 0, "order1",
                              "bfloat16"),
        "goursat_gram_fused": (dx, dy[:2], ops.choose_T(20, 17, 0, 0, 6, d=4), 0, 0, "order1",
                               "float32"),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["goursat_bwd", "goursat_fwd", "goursat_fwd_cps",
                                  "goursat_fwd_fused", "goursat_gram_fused"])
def test_goursat_op_opcheck_on_the_card(cuda, name):
    """Schema and fake implementation of each kernel's op against the
    kernel itself."""
    res = torch.library.opcheck(getattr(ops, name), _op_cases(cuda)[name],
                                test_utils=("test_schema", "test_faketensor"))
    assert set(res.values()) == {"SUCCESS"}


@pytest.mark.gpu
@pytest.mark.parametrize("backend, lift", [("gpu", "linear"), ("gpu", "rbf"),
                                           ("gpu_fused", "linear")])
def test_guarded_reduction_on_the_card_is_bit_for_bit(cuda, backend, lift, monkeypatch):
    """The streaming guard on card tensors: mmd2's value and gradient bit for
    bit the unguarded call's, the launches by shape equal; the dense Gram
    raises, traced with no allocation and no launch."""
    from repro_torch.core import gram
    X, Y = _incs(41, 24, 33, 4, cuda).cumsum(1), _incs(42, 17, 33, 4, cuda).cumsum(1)
    static = rt.RBF(1.0) if lift == "rbf" else None

    def run(guarded):
        with monkeypatch.context() as m:
            if not guarded:
                m.setattr(gram, "_guard_reduce", lambda *a, **k: None)
            kernel.reset_launch_counts()
            a, b = X.clone().requires_grad_(), Y.clone().requires_grad_()
            v = rt.mmd2(a, b, row_block=4, backend=backend, static_kernel=static)
            ga, gb = torch.autograd.grad(v, (a, b))
            torch.cuda.synchronize()
            return (v, ga, gb), kernel.launch_shapes()

    gram._stream_checked.clear()
    got, shapes_got = run(True)
    want, shapes_want = run(False)
    for p, q in zip(got, want):
        assert torch.equal(p, q)
    assert shapes_got == shapes_want and shapes_got
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel.reset_launch_counts()
    with pytest.raises(gram.StreamingViolation, match=r"\(24, 17\)"):
        gram.assert_streaming_reduction(
            lambda a, b: rt.sigkernel_gram(a, b, backend=backend, static_kernel=static).sum(),
            X, Y, gram_shape=(24, 17), grad=True)
    assert torch.cuda.max_memory_allocated() - base < 1 << 20
    assert not kernel.launch_shapes()
