"""Hopper kernels for the Goursat-PDE signature kernel, forward and exact
backward, and their plain PyTorch versions.

The CUDA C++ lives in ``csrc/sigkernel_pde.cu`` (its header comment gives
the design, what bounds each kernel on an H100 and what the design does
about it).  It is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/`` beside this module
(:mod:`repro_torch.kernels._build`), and loaded with ``ctypes``.

Five launchers, one per replaced Pallas kernel (or kernel mode) of the JAX
package:

=================  =================================================
``fwd``            ``repro/kernels/sigkernel_pde/kernel.py:fwd_kernel``
                   (+ ``_wavefront``), without checkpoint rows
``fwd_cps``        the same kernel with ``save_cps=True``: k and the
                   per-strip checkpoint rows the backward starts from
``fwd_fused``      ``kernel.py:fused_fwd_kernel``
``gram_fused``     ``kernel.py:fused_gram_kernel``
``bwd``            ``grad_kernel.py:bwd_kernel``: the exact adjoint
                   (Alg 4), strip by strip from the bottom up
=================  =================================================

Each launcher takes CUDA float32 tensors only, allocates its outputs (and
the backward's workspace) with ``torch.empty``, launches on the current
stream and adds one to its ``launches`` count (and to :func:`launch_shapes`,
by problem shape and strip height).  Beside each is its plain version
(``solve_plain``, ``solve_with_grid_plain``, ``solve_fused_plain``,
``gram_fused_plain``, ``solve_grad_plain``): vectorised anti-diagonal
wavefronts in PyTorch, with Δ built by ``einsum`` for the fused pair.
``fused_band_plain`` mirrors how the fused kernels build Δ: band by band,
as 16 x 8 tiles, through the same staged rows, ring and skewed band.  The
kernels round every operation as these elementwise ops do and take the
fused dot product in float64, as :func:`stencil.delta_einsum` does, so on
the card each forward kernel matches its plain version bit for bit in
practice, and the backward differs only in the order of the dyadic fold's
sums (chip_smoke.py checks both).  The wrappers in ``ops.py`` take the
plain version for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

from . import stencil
from .. import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "sigkernel_pde.cu"

#: shared memory one block may use on an H100 (opt-in, 227 KB)
SMEM_LIMIT = 232448
#: threads per block
MAX_THREADS = 1024
#: strip height of the fused kernels (kFusedMaxT in the CUDA source: their
#: blocks add producer warps to the T wavefront threads)
FUSED_MAX_THREADS = 512
#: threads per block of the backward kernel (kBwdMaxThreads in the CUDA
#: source: its launch bound leaves each thread 128 registers)
BWD_MAX_THREADS = 512
#: wavefront steps whose Δ entries a thread gathers at once (kGroup in the
#: CUDA source)
GROUP = 8
#: wavefront steps per Δ band of the fused kernels (kBand in the CUDA source)
BAND = 32
#: reverse steps per dΔ tile of the backward kernel (kFlush in the CUDA
#: source)
FLUSH = 16

_lib = None
_lib_lock = threading.Lock()
_SHAPES: Counter = Counter()


def library_path() -> Path:
    """Where the built library lives: keyed by the source and the flags."""
    return _build.library_path(_SRC, "sigkernel_pde")


def build() -> Path:
    """Compile the kernels unless this source was already built; return the
    library path (``nvcc.log`` beside it keeps the ptxas report)."""
    return _build.build(_SRC, "sigkernel_pde")


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.sigkernel_pde_fwd.argtypes = [p, p, ll, i, i, i, i, i, i, i, ll, p]
            lib.sigkernel_pde_fwd_fused.argtypes = [p, p, p, ll, i, i, i, i, i, i,
                                                    i, i, ll, p]
            lib.sigkernel_pde_gram_fused.argtypes = [p, p, p, ll, ll, i, i, i, i,
                                                     i, i, i, i, ll, p]
            lib.sigkernel_pde_fwd_cps.argtypes = [p, p, p, ll, i, i, i, i, i, i, i,
                                                  ll, p]
            lib.sigkernel_pde_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i,
                                              ll, p]
            for fn in (lib.sigkernel_pde_fwd, lib.sigkernel_pde_fwd_fused,
                       lib.sigkernel_pde_gram_fused, lib.sigkernel_pde_fwd_cps,
                       lib.sigkernel_pde_bwd):
                fn.restype = ctypes.c_int
            lib.sigkernel_pde_smem_bytes.argtypes = [i, i, i, i, i, i, i]
            lib.sigkernel_pde_smem_bytes.restype = ll
            lib.sigkernel_pde_error_string.argtypes = [ctypes.c_int]
            lib.sigkernel_pde_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class BandGeometry(NamedTuple):
    """The fused kernels' Δ band layout (``band_geometry`` in the CUDA
    source): RP staged dx rows (R = T >> lam1 rounded up to blocks of 16),
    row stride S of the staged rows and the dy ring (d padded to the MMA's
    k = 8, plus 4), NT column tiles of 8 per 16-row block, WB unrefined
    columns a band row holds at stride BS (odd), NR ring rows (the columns
    two consecutive bands read) and NY, the most dy rows a band adds."""
    RP: int
    S: int
    NT: int
    WB: int
    BS: int
    NR: int
    NY: int


def band_geometry(T: int, lam1: int, lam2: int, d: int) -> BandGeometry:
    m = 1 << lam1
    RP = -(-(T >> lam1) // 16) * 16
    NT = ((((BAND + 16 * m - 2) >> lam2) + 2) + 7) // 8
    WB = ((BAND + m - 2) >> lam2) + 2
    return BandGeometry(RP=RP, S=-(-d // 8) * 8 + 4, NT=NT, WB=WB, BS=WB | 1,
                        NR=((BAND + (RP - 16) * m) >> lam2) + 8 * NT + 1,
                        NY=(BAND >> lam2) + 1)


def smem_bytes(fused: bool, scheme: str, T: int, Ly: int, lam1: int, lam2: int,
               d: int = 0) -> int:
    """Shared memory one block takes: the carried boundary row(s) of length
    ny+T+1 and three anti-diagonals of T floats, and for the fused kernels
    the strip's staged dx rows, the dy ring, two bands and a band's new dy
    rows, all float32 (:class:`BandGeometry`; mirrors ``smem_bytes`` in the
    CUDA source, which checks it)."""
    rows = 2 if scheme == "order2" else 1
    n = 4 * (rows * ((Ly << lam2) + T + 1) + 3 * T)
    if fused:
        g = band_geometry(T, lam1, lam2, d)
        n += 4 * ((g.RP + g.NR) * g.S + 2 * (T >> lam1) * g.BS + g.NY * d)
    return n


def ws_stride(T: int) -> int:
    """Floats per workspace row of the backward kernel (``ws_stride`` in the
    CUDA source): T, at least 4, so that every row starts on 16 bytes for
    the bulk copies."""
    return max(T, 4)


def smem_bytes_bwd(scheme: str, T: int, Ly: int, lam1: int, lam2: int) -> int:
    """Shared memory one block of the backward kernel takes (mirrors
    ``smem_bytes_bwd`` in the CUDA source): two mbarriers, two staged groups
    of GROUP+1 workspace rows, two dΔ tiles of T x FLUSH (at a stride of
    FLUSH+1), the checkpoint row(s) of length ny+T+1, three forward
    anti-diagonals, the adjoint product rows carried up from the strip below
    (2, or 4 for order2, of ny+2), three rotating anti-diagonals of each
    adjoint product (2 or 3 products) and the fold's slots."""
    order2 = scheme == "order2"
    ny = Ly << lam2
    n = (2 * (GROUP + 1) * ws_stride(T) + 2 * T * (FLUSH + 1)
         + (2 if order2 else 1) * (ny + T + 1) + 3 * T + (4 if order2 else 2) * (ny + 2)
         + (9 if order2 else 6) * T + T)
    return 16 + 4 * n


def cps_rows(scheme: str) -> int:
    """Checkpoint rows per strip (brow, plus brow2 for the order-2 stencil)."""
    return 2 if scheme == "order2" else 1


def n_strips(Lx: int, T: int, lam1: int) -> int:
    """Strips of T refined rows (R = T >> lam1 unrefined rows) covering Lx."""
    R = T >> lam1
    return -(-Lx // R)


def check_strip(T: int, lam1: int, scheme: str, max_threads: int = MAX_THREADS) -> None:
    """Validate a strip height for the kernels; raise ValueError otherwise."""
    if T < 2 or T > max_threads or T & (T - 1) or (T >> lam1) < 1:
        raise ValueError(
            f"Goursat strip height T={T} must be a power of two in "
            f"[max(2, 2**lam1={1 << lam1}), {max_threads}] (one thread per "
            f"refined row) — set LaunchConfig.pde_strip accordingly")
    stencil.check_scheme(scheme)


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        name = library().sigkernel_pde_error_string(err).decode()
        raise RuntimeError(f"Goursat kernel launch failed: CUDA error {err} ({name})")
    return out


def _smem_checked(fused, scheme, T, Ly, lam1, lam2, d=0, backward=False) -> int:
    if backward:
        check_strip(T, lam1, scheme, BWD_MAX_THREADS)
        smem = smem_bytes_bwd(scheme, T, Ly, lam1, lam2)
    else:
        check_strip(T, lam1, scheme, FUSED_MAX_THREADS if fused else MAX_THREADS)
        smem = smem_bytes(fused, scheme, T, Ly, lam1, lam2, d)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"Goursat kernel needs {smem} bytes of shared memory per block "
            f"(T={T}, ny={Ly << lam2}, scheme={scheme!r}), above the "
            f"{SMEM_LIMIT}-byte limit of one H100 block")
    return smem


def fwd(delta: torch.Tensor, T: int, lam1: int, lam2: int, scheme: str,
        interior_dtype: str) -> torch.Tensor:
    """k̂[nx, ny] for Δ (B, Lx, Ly) on the card: one block per problem."""
    _check(delta, "delta", 3)
    stencil.check_interior_dtype(interior_dtype)
    B, Lx, Ly = delta.shape
    smem = _smem_checked(False, scheme, T, Ly, lam1, lam2)
    out = torch.empty(B, device=delta.device, dtype=torch.float32)
    if B == 0:
        return out
    _launch(library().sigkernel_pde_fwd, out, delta.data_ptr(), out.data_ptr(), B,
            Lx, Ly, T, lam1, lam2, scheme == "order2",
            interior_dtype == "bfloat16", smem)
    fwd.launches += 1
    _SHAPES[("fwd", B, Lx, Ly, 0, T)] += 1
    return out


def fwd_fused(dx: torch.Tensor, dy: torch.Tensor, T: int, lam1: int, lam2: int,
              scheme: str, interior_dtype: str) -> torch.Tensor:
    """k̂[nx, ny] for matched pairs dx (B, Lx, d), dy (B, Ly, d), Δ built in
    the kernel."""
    _check(dx, "dx", 3)
    _check(dy, "dy", 3)
    stencil.check_interior_dtype(interior_dtype)
    B, Lx, d = dx.shape
    if dy.shape[0] != B or dy.shape[2] != d or dy.device != dx.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not pair with dx {tuple(dx.shape)}")
    Ly = dy.shape[1]
    smem = _smem_checked(True, scheme, T, Ly, lam1, lam2, d)
    out = torch.empty(B, device=dx.device, dtype=torch.float32)
    if B == 0:
        return out
    _launch(library().sigkernel_pde_fwd_fused, out, dx.data_ptr(), dy.data_ptr(),
            out.data_ptr(), B, Lx, Ly, d, T, lam1, lam2, scheme == "order2",
            interior_dtype == "bfloat16", smem)
    fwd_fused.launches += 1
    _SHAPES[("fwd_fused", B, Lx, Ly, d, T)] += 1
    return out


def gram_fused(dX: torch.Tensor, dY: torch.Tensor, T: int, lam1: int, lam2: int,
               scheme: str, interior_dtype: str) -> torch.Tensor:
    """Gram (Bx, By) from increments dX (Bx, Lx, d), dY (By, Ly, d), one
    block per (row path, column path), Δ built in the kernel."""
    _check(dX, "dX", 3)
    _check(dY, "dY", 3)
    stencil.check_interior_dtype(interior_dtype)
    Bx, Lx, d = dX.shape
    By, Ly = dY.shape[0], dY.shape[1]
    if dY.shape[2] != d or dY.device != dX.device:
        raise ValueError(f"dY {tuple(dY.shape)} does not pair with dX {tuple(dX.shape)}")
    smem = _smem_checked(True, scheme, T, Ly, lam1, lam2, d)
    out = torch.empty(Bx, By, device=dX.device, dtype=torch.float32)
    if Bx * By == 0:
        return out
    _launch(library().sigkernel_pde_gram_fused, out, dX.data_ptr(), dY.data_ptr(),
            out.data_ptr(), Bx, By, Lx, Ly, d, T, lam1, lam2, scheme == "order2",
            interior_dtype == "bfloat16", smem)
    gram_fused.launches += 1
    _SHAPES[("gram_fused", (Bx, By), Lx, Ly, d, T)] += 1
    return out


def fwd_cps(delta: torch.Tensor, T: int, lam1: int, lam2: int, scheme: str,
            interior_dtype: str):
    """``(k, cps)`` for Δ (B, Lx, Ly) on the card: k̂[nx, ny] and the
    checkpoint rows (B, n_strips·rows, ny+T+1) at strip height T — for
    strip s, row s·rows holds k̂[s·T, ·] and (order2) row s·rows+1 holds
    k̂[s·T−1, ·], each as the carried row stood when the strip began, in
    the layout of the JAX kernel's ``save_cps=True`` output."""
    _check(delta, "delta", 3)
    stencil.check_interior_dtype(interior_dtype)
    B, Lx, Ly = delta.shape
    smem = _smem_checked(False, scheme, T, Ly, lam1, lam2)
    out = torch.empty(B, device=delta.device, dtype=torch.float32)
    cps = torch.empty(B, n_strips(Lx, T, lam1) * cps_rows(scheme), (Ly << lam2) + T + 1,
                      device=delta.device, dtype=torch.float32)
    if B == 0:
        return out, cps
    _launch(library().sigkernel_pde_fwd_cps, out, delta.data_ptr(), out.data_ptr(),
            cps.data_ptr(), B, Lx, Ly, T, lam1, lam2, scheme == "order2",
            interior_dtype == "bfloat16", smem)
    fwd_cps.launches += 1
    _SHAPES[("fwd_cps", B, Lx, Ly, 0, T)] += 1
    return out, cps


def bwd(delta: torch.Tensor, cps: torch.Tensor, gbar: torch.Tensor, T: int, lam1: int,
        lam2: int, scheme: str, interior_dtype: str) -> torch.Tensor:
    """∂F/∂Δ (B, Lx, Ly) on the card from Δ, the checkpoint rows that
    :func:`fwd_cps` wrote at the same strip height T, and ḡ = ∂F/∂k (B,).
    Allocates the recomputed-strip workspace, B·(ny+T−1)·max(T, 4) floats."""
    _check(delta, "delta", 3)
    _check(cps, "cps", 3)
    _check(gbar, "gbar", 1)
    stencil.check_interior_dtype(interior_dtype)
    B, Lx, Ly = delta.shape
    smem = _smem_checked(False, scheme, T, Ly, lam1, lam2, backward=True)
    ny = Ly << lam2
    want = (B, n_strips(Lx, T, lam1) * cps_rows(scheme), ny + T + 1)
    if tuple(cps.shape) != want or tuple(gbar.shape) != (B,) \
            or cps.device != delta.device or gbar.device != delta.device:
        raise ValueError(
            f"cps {tuple(cps.shape)} / gbar {tuple(gbar.shape)} do not match Δ "
            f"{tuple(delta.shape)} at strip height T={T} (want cps {want}): the "
            f"backward's strips must line up with the forward's checkpoint rows")
    out = torch.empty(B, Lx, Ly, device=delta.device, dtype=torch.float32)
    if B == 0:
        return out
    ws = torch.empty(B * (ny + T - 1) * ws_stride(T), device=delta.device,
                     dtype=torch.float32)
    _launch(library().sigkernel_pde_bwd, out, delta.data_ptr(), cps.data_ptr(),
            gbar.data_ptr(), ws.data_ptr(), out.data_ptr(), B, Lx, Ly, T, lam1, lam2,
            scheme == "order2", interior_dtype == "bfloat16", smem)
    bwd.launches += 1
    _SHAPES[("bwd", B, Lx, Ly, 0, T)] += 1
    return out


LAUNCHERS = (fwd, fwd_cps, fwd_fused, gram_fused, bwd)


def reset_launch_counts() -> None:
    """Set every launcher's ``launches`` count, and the shape log, to 0."""
    for fn in LAUNCHERS:
        fn.launches = 0
    _SHAPES.clear()


def launch_counts() -> dict:
    """``{launcher name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in LAUNCHERS}


def launch_shapes() -> dict:
    """``{(launcher name, problems, Lx, Ly, d, T): launches}`` since the last
    reset (problems is (Bx, By) for ``gram_fused``; d = 0 for the kernels
    that read a precomputed Δ)."""
    return dict(_SHAPES)


reset_launch_counts()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def solve_plain(delta: torch.Tensor, lam1: int, lam2: int, scheme: str,
                interior_dtype: str) -> torch.Tensor:
    """Plain version of :func:`fwd`: the vectorised anti-diagonal wavefront."""
    from repro_torch.core.sigkernel import solve_goursat_antidiag
    return solve_goursat_antidiag(delta, lam1, lam2, scheme=scheme,
                                  interior_dtype=interior_dtype)


def solve_fused_plain(dx: torch.Tensor, dy: torch.Tensor, lam1: int, lam2: int,
                      scheme: str, interior_dtype: str) -> torch.Tensor:
    """Plain version of :func:`fwd_fused`: Δ by einsum, then the wavefront."""
    return solve_plain(stencil.delta_einsum("bid,bjd->bij", dx, dy), lam1, lam2, scheme,
                       interior_dtype)


def gram_fused_plain(dX: torch.Tensor, dY: torch.Tensor, lam1: int, lam2: int,
                     scheme: str, interior_dtype: str) -> torch.Tensor:
    """Plain version of :func:`gram_fused`: pairwise Δ by einsum, then the
    wavefront."""
    return solve_plain(stencil.delta_einsum("aid,bjd->abij", dX, dY), lam1, lam2, scheme,
                       interior_dtype)


def fused_band_plain(dx: torch.Tensor, dy: torch.Tensor, T: int, lam1: int,
                     lam2: int) -> torch.Tensor:
    """How the fused kernels build Δ, in plain PyTorch: for pairs dx (B, Lx,
    d), dy (B, Ly, d) at strip height T, the refined Δ entry every lane
    uses at every step (the band's unrefined entry times 2^−(λ1+λ2)), as
    (B, n_strips·T, ny) in the layout of :func:`_refined_strips` (rows past
    nx zero).

    Strip by strip, as the kernel does it (:class:`BandGeometry`): the
    strip's dx rows are staged (zero past R, past Lx and in the k padding);
    dy rows enter a ring (row j at slot j % NR) one band ahead, before the
    band built beside them reads the ring; each band of ``BAND`` steps is
    assembled from 16 x 8 tiles (rows i0..i0+15, columns from jlo(i0+15);
    tiles with no column in 0..Ly−1 skipped), each a float64 product over
    the padded k, rounded once to dx's dtype and written skewed to
    band[i][j − jlo(i)]; lane r reads its cell (r, c) at
    band[r >> lam1][(c >> lam2) − jlo(r >> lam1)].  Band entries no tile
    wrote and ring rows not yet loaded are NaN, so a read the kernel could
    not serve shows in the result.
    """
    B, Lx, d = dx.shape
    Ly = dy.shape[1]
    g = band_geometry(T, lam1, lam2, d)
    m, R, ny = 1 << lam1, T >> lam1, Ly << lam2
    steps = ny + T - 1
    dev, f64, nan = dx.device, torch.float64, float("nan")
    lanes = torch.arange(T, device=dev)
    lrow = lanes >> lam1
    g8, g16 = torch.arange(8, device=dev), torch.arange(16, device=dev)
    i0 = 16 * torch.arange(g.RP // 16, device=dev)              # row blocks
    rr = torch.arange(g.RP, device=dev)
    out = dx.new_zeros(B, n_strips(Lx, T, lam1) * T, ny)

    def last_col(t0):  # the highest dy row the band at step t0 reads
        return ((t0 - 16 * m + 1) >> lam2) + 8 * g.NT - 1

    for s in range(n_strips(Lx, T, lam1)):
        live = (rr < R) & (s * R + rr < Lx)
        sdx = torch.zeros(B, g.RP, g.S, dtype=f64, device=dev)
        sdx[:, live, :d] = dx[:, s * R + rr[live]].to(f64)
        ring = torch.full((B, g.NR, g.S), nan, dtype=f64, device=dev)
        ring[:, :, d:] = 0.0
        loaded = -1

        def fill(hi):
            nonlocal loaded
            hi = min(hi, Ly - 1)
            if hi > loaded:
                j = torch.arange(loaded + 1, hi + 1, device=dev)
                ring[:, j % g.NR, :d] = dy[:, j].to(f64)
                loaded = hi

        def build(t0):
            j0 = ((t0 - (i0 + 16) * m + 1) >> lam2)[:, None] + 8 * torch.arange(g.NT)
            cols = j0[..., None] + g8                               # (NB, NT, 8)
            ok = ((cols >= 0) & (cols < Ly))[..., None]
            Y = torch.where(ok, ring[:, cols % g.NR], 0.0)          # (B, NB, NT, 8, S)
            tiles = torch.einsum("bnik,bnujk->bnuij", sdx.reshape(B, -1, 16, g.S), Y)
            i = (i0[:, None] + g16)[:, None, :, None]               # (NB, 1, 16, 1)
            q = cols[:, :, None, :] - ((t0 - i * m - m + 1) >> lam2)
            # tiles with no column in 0 .. Ly-1 are skipped
            tile_live = ((j0 + 7 >= 0) & (j0 < Ly))[:, :, None, None]
            keep = (i < R) & (q >= 0) & (q < g.WB) & tile_live
            band = torch.full((B, R, g.WB), nan, dtype=dx.dtype, device=dev)
            band[:, i.expand_as(q)[keep], q[keep]] = tiles[:, keep].to(dx.dtype)
            return band

        fill(last_col(0))
        for t0 in range(0, steps, BAND):
            if t0 + BAND < steps:
                fill(last_col(t0 + BAND))
            band = build(t0)
            jlo = (t0 - lrow * m - m + 1) >> lam2
            for t in range(t0, min(t0 + BAND, steps)):
                c = t - lanes
                on = (c >= 0) & (c < ny)
                out[:, s * T + lanes[on], c[on]] = band[:, lrow[on], (c[on] >> lam2) - jlo[on]]
    return out * 2.0 ** -(lam1 + lam2)


def _refined_strips(delta: torch.Tensor, T: int, lam1: int, lam2: int) -> torch.Tensor:
    """Refined Δ (B, n_strips·T, ny), rows past nx zero (the strip padding
    the kernels do by index arithmetic)."""
    from repro_torch.core.sigkernel import _refine
    B, Lx, Ly = delta.shape
    pad = n_strips(Lx, T, lam1) * (T >> lam1) - Lx
    if pad:
        delta = torch.cat([delta, delta.new_zeros(B, pad, Ly)], dim=1)
    return _refine(delta, lam1, lam2)


def _skew(M: torch.Tensor) -> torch.Tensor:
    """(N, n_lanes, n) -> (n_lanes + n − 1, N, n_lanes) with
    out[t, :, r] = M[:, r, t − r] (0 off the grid)."""
    N, nl, n = M.shape
    lanes = torch.arange(nl, device=M.device)
    idx = torch.arange(nl + n - 1, device=M.device)[None, :] - lanes[:, None]
    on = (idx >= 0) & (idx < n)
    out = torch.gather(M, 2, idx.clamp(0, n - 1).expand(N, nl, nl + n - 1))
    out = torch.where(on, out, torch.zeros((), dtype=M.dtype, device=M.device))
    return out.permute(2, 0, 1)


def _unskew(D: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`_skew`: (n_lanes + n − 1, N, n_lanes) -> (N, n_lanes, n)."""
    nl = D.shape[2]
    idx = (torch.arange(nl, device=D.device)[:, None]
           + torch.arange(n, device=D.device)[None, :])
    return torch.gather(D.permute(1, 2, 0), 2, idx.expand(D.shape[1], nl, n))


def _strip_wavefront(P: torch.Tensor, brow: torch.Tensor, brow2, lam1: int, lam2: int,
                     scheme: str, interior_dtype: str) -> torch.Tensor:
    """One strip of T refined rows, all N strips at once: refined Δ (N, T,
    ny) under carried rows brow = k̂[top, ·] and brow2 = k̂[top−1, ·] (N, ≥
    ny+T) -> k̂[top+1..top+T, 1..ny] (N, T, ny).  The arithmetic of the
    kernels' wavefront: lane r computes cell (r, t − r) at step t, lane 0
    reads the carried rows, order2's k_ul reads brow2/brow in lanes 0/1."""
    N, T, ny = P.shape
    dev, dt = P.device, P.dtype
    lanes = torch.arange(T, device=dev)
    Psk = _skew(P)
    prev = torch.zeros(N, T, dtype=dt, device=dev)
    prev2 = torch.zeros(N, T, dtype=dt, device=dev)
    order2 = scheme == "order2"
    m1, m2 = 1 << lam1, 1 << lam2
    diags = []
    for t in range(ny + T - 1):
        p = Psk[t]
        c = t - lanes
        first = c == 0
        up = torch.cat([brow[:, t + 1:t + 2], prev[:, :-1]], dim=1)
        upleft = torch.where(first, 1.0, torch.cat([brow[:, t:t + 1], prev2[:, :-1]], dim=1))
        left = torch.where(first, 1.0, prev)
        if order2:
            edge = (lanes % m1 == 0) | (c % m2 == 0)
            k_dl = torch.where(c <= 1, 1.0, prev2)
            k_ul = torch.cat([brow2[:, t + 1:t + 2], brow[:, t:t + 1], prev2[:, :-2]], dim=1)
            cur = ((left + up) * stencil.coeff_A(p)
                   - upleft * stencil.coeff_B2_at(p, edge)
                   - (k_dl + k_ul) * stencil.coeff_C2_at(p, edge))
        else:
            cur = (left + up) * stencil.coeff_A(p) - upleft * stencil.coeff_B1(p)
        cur = stencil.round_interior(cur, interior_dtype)
        cur = torch.where((c >= 0) & (c < ny), cur, 0.0)
        prev2, prev = prev, cur
        diags.append(cur)
    return _unskew(torch.stack(diags), ny)


def solve_with_grid_plain(delta: torch.Tensor, T: int, lam1: int, lam2: int,
                          scheme: str, interior_dtype: str):
    """Plain version of :func:`fwd_cps`: the strips swept in order, each by
    :func:`_strip_wavefront`, carrying brow (and brow2) as the kernel does.
    Returns ``(k, cps)``; T is any multiple of 2^λ1 that is at least 2."""
    B, Lx, Ly = delta.shape
    nx, ny = Lx << lam1, Ly << lam2
    S = n_strips(Lx, T, lam1)
    P = _refined_strips(delta, T, lam1, lam2)
    order2 = scheme == "order2"
    brow = delta.new_ones(B, ny + T + 1)
    brow2 = delta.new_ones(B, ny + T + 1) if order2 else None
    cps = []
    for s in range(S):
        cps.extend([brow, brow2] if order2 else [brow])
        rows = _strip_wavefront(P[:, s * T:(s + 1) * T], brow, brow2, lam1, lam2,
                                scheme, interior_dtype)
        if order2:
            # row T−2 becomes brow2[1..ny]; its write one past the row is
            # the inactive cell's 0, as in the kernel
            brow2 = torch.cat([brow2[:, :1], rows[:, T - 2], brow2.new_zeros(B, 1),
                               brow2[:, ny + 2:]], dim=1)
        brow = torch.cat([brow[:, :1], rows[:, T - 1], brow[:, ny + 1:]], dim=1)
    k = rows[:, nx - 1 - (S - 1) * T, ny - 1]
    return k, torch.stack(cps, dim=1)


def solve_grad_plain(delta: torch.Tensor, cps: torch.Tensor, gbar: torch.Tensor, T: int,
                     lam1: int, lam2: int, scheme: str, interior_dtype: str) -> torch.Tensor:
    """Plain version of :func:`bwd`: ∂F/∂Δ (B, Lx, Ly).

    1. Every strip's interior is rebuilt from its checkpoint rows, all
       strips at once (:func:`_strip_wavefront`), with the forward's
       rounding.
    2. A reverse anti-diagonal wavefront over the nx real rows computes the
       adjoint g(r, c) = ∂F/∂k̂[r+1, c+1] from each writer cell's products
       g·A, g·B and (order2) g·C, in the backward kernel's order of
       operations, seeded with ḡ at cell (nx−1, ny−1).
    3. The dΔ terms of every cell, then the dyadic fold onto (Lx, Ly).
    """
    B, Lx, Ly = delta.shape
    nx, ny = Lx << lam1, Ly << lam2
    S = n_strips(Lx, T, lam1)
    m1, m2 = 1 << lam1, 1 << lam2
    order2 = scheme == "order2"
    dev, dt = delta.device, delta.dtype
    rows = cps_rows(scheme)
    P = _refined_strips(delta, T, lam1, lam2)
    strips = _strip_wavefront(
        P.reshape(B * S, T, ny), cps[:, 0::rows].reshape(B * S, -1),
        cps[:, 1::rows].reshape(B * S, -1) if order2 else None,
        lam1, lam2, scheme, interior_dtype)
    K = torch.ones(B, nx + 1, ny + 1, dtype=dt, device=dev)
    K[:, 1:, 1:] = strips.reshape(B, S * T, ny)[:, :nx]
    P = P[:, :nx]

    # ---- reverse adjoint wavefront ----
    lanes = torch.arange(nx, device=dev)
    Psk = _skew(P)
    z = torch.zeros(B, nx + 2, dtype=dt, device=dev)
    gA1, gB1, gC1, gB2, gC2 = z, z, z, z, z      # products at steps t+1, t+2
    n_steps = nx + ny - 1
    seed = torch.where(lanes == nx - 1, gbar.to(dt)[:, None], 0.0)
    Gs = [None] * n_steps
    for t in range(n_steps - 1, -1, -1):
        p = Psk[t]
        c = t - lanes
        g = (gA1[:, :nx] + gA1[:, 1:nx + 1]) - gB2[:, 1:nx + 1]
        if order2:
            g = (g - gC2[:, :nx]) - gC2[:, 2:]
        if t == n_steps - 1:
            g = g + seed
        g = torch.where((c >= 0) & (c < ny), g, 0.0)
        Gs[t] = g
        if order2:
            edge = (lanes % m1 == 0) | (c % m2 == 0)
            bq, cq = stencil.coeff_B2_at(p, edge), stencil.coeff_C2_at(p, edge)
        else:
            bq = stencil.coeff_B1(p)
        pad = torch.zeros(B, 2, dtype=dt, device=dev)
        gB2, gC2 = gB1, gC1
        gA1 = torch.cat([g * stencil.coeff_A(p), pad], dim=1)
        gB1 = torch.cat([g * bq, pad], dim=1)
        gC1 = torch.cat([g * cq, pad], dim=1) if order2 else z
    G = _unskew(torch.stack(Gs), ny)                         # (B, nx, ny)

    # ---- dΔ of every cell, then the dyadic fold ----
    k_left, k_up, k_upleft = K[:, 1:, :-1], K[:, :-1, 1:], K[:, :-1, :-1]
    if order2:
        r_idx = torch.arange(nx, device=dev)[:, None]
        c_idx = torch.arange(ny, device=dev)[None, :]
        edge = (r_idx % m1 == 0) | (c_idx % m2 == 0)
        k_dl = torch.cat([torch.ones_like(K[:, 1:, :1]), K[:, 1:, :-2]], dim=2)
        k_ul = torch.cat([torch.ones_like(K[:, :1, 1:]), K[:, :-2, 1:]], dim=1)
        contrib = G * ((k_left + k_up) * stencil.coeff_dA(P)
                       - k_upleft * stencil.coeff_dB2_at(P, edge)
                       - (k_dl + k_ul) * stencil.coeff_dC2_at(P, edge))
    else:
        contrib = G * ((k_left + k_up) * stencil.coeff_dA(P)
                       - k_upleft * stencil.coeff_dB1(P))
    return contrib.reshape(B, Lx, m1, Ly, m2).sum((2, 4)) * 2.0 ** (-(lam1 + lam2))
