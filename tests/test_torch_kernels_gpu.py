"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

The Goursat kernels (``repro_torch/kernels/sigkernel_pde/csrc``) and the
Horner kernel (``repro_torch/kernels/signature/csrc``) have no CPU mode:
these tests need a CUDA card and skip without one.  The file imports
no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

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
    T = ops.choose_T(44, 29, *lam, 3, scheme=scheme, max_t=strip, backward=True)
    before = (kernel.fwd_cps.launches, kernel.bwd.launches)
    k, cps = kernel.fwd_cps(delta, T, *lam, scheme, idt)
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
    k, cps = kernel.fwd_cps(delta, 2, 0, 1, scheme, "float32")
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
    smem_bytes, which the launch checks, for every forward mode."""
    lib = kernel.library()
    for T in (2, 4, 16, 32, 64, 256, 512):
        for lam1, lam2 in ((0, 0), (1, 2), (2, 0), (0, 3)):
            if T >> lam1 < 1:
                continue
            for scheme in ("order1", "order2"):
                for mode, d in ((0, 0), (1, 1), (1, 8), (1, 33), (2, 32)):
                    want = lib.sigkernel_pde_smem_bytes(mode, scheme == "order2", T, 255,
                                                        lam1, lam2, d)
                    assert kernel.smem_bytes(mode > 0, scheme, T, 255, lam1, lam2, d) == want


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
