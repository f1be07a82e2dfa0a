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
as 16 x 8 tiles, through the same staged rows, ring and skewed band;
``fwd_wavefront_plain`` runs the precomputed-Δ forward's own schedule (R
rows a lane, warps handing band edges down through mbarrier rings, the
checkpoint rows written by the lanes that own them).  The
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
from typing import Dict, NamedTuple

import torch

from . import stencil
from .. import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "sigkernel_pde.cu"

#: shared memory one block may use on an H100 (opt-in, 227 KB)
SMEM_LIMIT = 232448
#: threads per block: the precomputed-Δ forward's launch bound, and the most
#: rows of a checkpoint strip (kMaxThreads)
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
#: the precomputed-Δ forward (goursat_fwd in the CUDA source): rows a lane
#: may own (R, its instantiations), wavefront steps a chunk (kChunk: Δ
#: staged, band edges handed over), ring slots between two warps (kSlots),
#: floats a staged line (kLine: 32 lanes and a pad) and staged chunks a warp
#: keeps (kStages)
FWD_ROWS = (1, 2)
CHUNK = 16
RING_SLOTS = 4
STAGE_LINE = 33
STAGES = 2
#: wavefront steps per Δ band of the fused kernels (kBand in the CUDA source)
BAND = 32
#: reverse steps per dΔ tile of the backward kernel (kFlush in the CUDA
#: source)
FLUSH = 16

_lib = None
_lib_lock = threading.Lock()
_SHAPES: Counter = Counter()
_VARIANTS: Dict[tuple, set] = {}


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
            lib.sigkernel_pde_fwd.argtypes = [p, p, ll, i, i, i, i, i, i, i, i, ll, p]
            lib.sigkernel_pde_fwd_fused.argtypes = [p, p, p, ll, i, i, i, i, i, i,
                                                    i, i, ll, p]
            lib.sigkernel_pde_gram_fused.argtypes = [p, p, p, ll, ll, i, i, i, i,
                                                     i, i, i, i, ll, p]
            lib.sigkernel_pde_fwd_cps.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, i,
                                                  i, ll, p]
            lib.sigkernel_pde_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i,
                                              ll, p]
            for fn in (lib.sigkernel_pde_fwd, lib.sigkernel_pde_fwd_fused,
                       lib.sigkernel_pde_gram_fused, lib.sigkernel_pde_fwd_cps,
                       lib.sigkernel_pde_bwd):
                fn.restype = ctypes.c_int
            lib.sigkernel_pde_smem_bytes.argtypes = [i] * 6
            lib.sigkernel_pde_smem_bytes.restype = ll
            lib.sigkernel_pde_fwd_smem_bytes.argtypes = [i] * 7
            lib.sigkernel_pde_fwd_smem_bytes.restype = ll
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


def smem_bytes(scheme: str, T: int, Ly: int, lam1: int, lam2: int, d: int) -> int:
    """Shared memory one block of a fused kernel takes at strip height T:
    the carried boundary row(s) of length ny+T+1, three anti-diagonals of T
    floats, the strip's staged dx rows, the dy ring, two bands and a band's
    new dy rows, all float32 (:class:`BandGeometry`; mirrors ``smem_bytes``
    in the CUDA source, which checks it).  The precomputed-Δ forward's block
    follows its geometry instead: :func:`fwd_smem_bytes`."""
    rows = 2 if scheme == "order2" else 1
    g = band_geometry(T, lam1, lam2, d)
    return 4 * (rows * ((Ly << lam2) + T + 1) + 3 * T + (g.RP + g.NR) * g.S
                + 2 * (T >> lam1) * g.BS + g.NY * d)


class FwdGeometry(NamedTuple):
    """Launch geometry of the precomputed-Δ forward (``ops.geometry`` picks
    it): R refined rows a lane (a warp covers a band of 32·R rows) and
    ``warps`` warps a problem (they take bands w, w + warps, ...), one
    problem a block."""
    R: int
    warps: int


def fwd_bands(nx: int, R: int) -> int:
    """Bands of 32·R refined rows covering nx."""
    return -(-nx // (32 * R))


def fwd_last_slots(nx: int, ny: int, R: int, warps: int) -> int:
    """Slots of the ring from a pass's last warp back to its first: none
    unless the warps loop over bands, then a whole row's chunks (at least
    RING_SLOTS)."""
    return max(RING_SLOTS, -(-ny // CHUNK)) if fwd_bands(nx, R) > warps else 0


def fwd_smem_bytes(scheme: str, geo: FwdGeometry, Lx: int, Ly: int, lam1: int,
                   lam2: int) -> int:
    """Shared memory one block of the forward takes (mirrors
    ``wave_smem_bytes`` in the CUDA source, which checks it): a chunk of
    ones (2·CHUNK floats, what the first band reads above it); two mbarriers
    (16 bytes) and CHUNK columns of the handed-over row(s) per ring slot;
    per warp, STAGES staged chunks of R x CHUNK lines of STAGE_LINE
    floats."""
    nx, ny = Lx << lam1, Ly << lam2
    rows = 2 if scheme == "order2" else 1
    slots = (geo.warps - 1) * RING_SLOTS + fwd_last_slots(nx, ny, geo.R, geo.warps)
    stage = STAGES * geo.R * CHUNK * STAGE_LINE
    return 8 * CHUNK + slots * (16 + 4 * CHUNK * rows) + 4 * geo.warps * stage


def check_fwd_geometry(geo: FwdGeometry, Lx: int, lam1: int, T=None) -> None:
    """Validate a forward geometry for the kernel (in the checkpoint mode at
    strip height T, a lane's rows hold at most one checkpoint row each:
    R <= T); raise ValueError otherwise."""
    R, warps = geo
    if (R not in FWD_ROWS or warps < 1 or 32 * warps > MAX_THREADS
            or warps > fwd_bands(Lx << lam1, R) or (T is not None and R > T)):
        raise ValueError(
            f"forward geometry {geo} does not fit: R in {FWD_ROWS} (at most the "
            f"checkpoint strip T={T}), at most {MAX_THREADS} threads a block and at "
            f"most one warp a band of {32 * R} rows")


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


def _smem_checked(scheme, T, Ly, lam1, lam2, d=0, backward=False) -> int:
    if backward:
        check_strip(T, lam1, scheme, BWD_MAX_THREADS)
        smem = smem_bytes_bwd(scheme, T, Ly, lam1, lam2)
    else:
        check_strip(T, lam1, scheme, FUSED_MAX_THREADS)
        smem = smem_bytes(scheme, T, Ly, lam1, lam2, d)
    return _fits(smem, f"T={T}, ny={Ly << lam2}, scheme={scheme!r}")


def _fits(smem: int, what: str) -> int:
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"Goursat kernel needs {smem} bytes of shared memory per block "
            f"({what}), above the {SMEM_LIMIT}-byte limit of one H100 block")
    return smem


def _fwd_smem_checked(delta: torch.Tensor, geo: FwdGeometry, lam1: int, lam2: int,
                      scheme: str, T=None) -> int:
    """The forward's shared memory at geometry ``geo``, once the geometry is
    checked (T: the checkpoint strip, if any)."""
    _, Lx, Ly = delta.shape
    check_fwd_geometry(geo, Lx, lam1, T)
    stencil.check_scheme(scheme)
    return _fits(fwd_smem_bytes(scheme, geo, Lx, Ly, lam1, lam2), f"geometry {geo}")


def fwd(delta: torch.Tensor, geo: FwdGeometry, lam1: int, lam2: int, scheme: str,
        interior_dtype: str) -> torch.Tensor:
    """k̂[nx, ny] for Δ (B, Lx, Ly) on the card at geometry ``geo``
    (``ops.geometry`` picks it)."""
    _check(delta, "delta", 3)
    stencil.check_interior_dtype(interior_dtype)
    B, Lx, Ly = delta.shape
    smem = _fwd_smem_checked(delta, geo, lam1, lam2, scheme)
    out = torch.empty(B, device=delta.device, dtype=torch.float32)
    if B == 0:
        return out
    _launch(library().sigkernel_pde_fwd, out, delta.data_ptr(), out.data_ptr(), B,
            Lx, Ly, *geo, lam1, lam2, scheme == "order2", interior_dtype == "bfloat16",
            smem)
    fwd.launches += 1
    _log(("fwd", B, Lx, Ly, 0, tuple(geo)), lam1, lam2, scheme, interior_dtype)
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
    smem = _smem_checked(scheme, T, Ly, lam1, lam2, d)
    out = torch.empty(B, device=dx.device, dtype=torch.float32)
    if B == 0:
        return out
    _launch(library().sigkernel_pde_fwd_fused, out, dx.data_ptr(), dy.data_ptr(),
            out.data_ptr(), B, Lx, Ly, d, T, lam1, lam2, scheme == "order2",
            interior_dtype == "bfloat16", smem)
    fwd_fused.launches += 1
    _log(("fwd_fused", B, Lx, Ly, d, T), lam1, lam2, scheme, interior_dtype)
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
    smem = _smem_checked(scheme, T, Ly, lam1, lam2, d)
    out = torch.empty(Bx, By, device=dX.device, dtype=torch.float32)
    if Bx * By == 0:
        return out
    _launch(library().sigkernel_pde_gram_fused, out, dX.data_ptr(), dY.data_ptr(),
            out.data_ptr(), Bx, By, Lx, Ly, d, T, lam1, lam2, scheme == "order2",
            interior_dtype == "bfloat16", smem)
    gram_fused.launches += 1
    _log(("gram_fused", (Bx, By), Lx, Ly, d, T), lam1, lam2, scheme, interior_dtype)
    return out


def fwd_cps(delta: torch.Tensor, T: int, lam1: int, lam2: int, scheme: str,
            interior_dtype: str, geo: FwdGeometry):
    """``(k, cps)`` for Δ (B, Lx, Ly) on the card: k̂[nx, ny] and the
    checkpoint rows (B, n_strips·rows, ny+T+1) at strip height T — for
    strip s, row s·rows holds k̂[s·T, ·] and (order2) row s·rows+1 holds
    k̂[s·T−1, ·], each as the carried row stood when the strip began, in
    the layout of the JAX kernel's ``save_cps=True`` output.  The kernel's
    geometry ``geo`` (``ops.geometry(..., T=T)`` picks it) is free of T but
    for R <= T."""
    _check(delta, "delta", 3)
    stencil.check_interior_dtype(interior_dtype)
    check_strip(T, lam1, scheme)
    B, Lx, Ly = delta.shape
    smem = _fwd_smem_checked(delta, geo, lam1, lam2, scheme, T)
    out = torch.empty(B, device=delta.device, dtype=torch.float32)
    cps = torch.empty(B, n_strips(Lx, T, lam1) * cps_rows(scheme), (Ly << lam2) + T + 1,
                      device=delta.device, dtype=torch.float32)
    if B == 0:
        return out, cps
    _launch(library().sigkernel_pde_fwd_cps, out, delta.data_ptr(), out.data_ptr(),
            cps.data_ptr(), B, Lx, Ly, T, *geo, lam1, lam2, scheme == "order2",
            interior_dtype == "bfloat16", smem)
    fwd_cps.launches += 1
    _log(("fwd_cps", B, Lx, Ly, 0, T), lam1, lam2, scheme, interior_dtype)
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
    smem = _smem_checked(scheme, T, Ly, lam1, lam2, backward=True)
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
    _log(("bwd", B, Lx, Ly, 0, T), lam1, lam2, scheme, interior_dtype)
    return out


LAUNCHERS = (fwd, fwd_cps, fwd_fused, gram_fused, bwd)


def _log(key: tuple, lam1: int, lam2: int, scheme: str, interior_dtype: str) -> None:
    """One launch at ``key`` (as :func:`launch_shapes` keys it) and the
    refinement, scheme and interior dtype it ran at."""
    _SHAPES[key] += 1
    _VARIANTS.setdefault(key, set()).add((lam1, lam2, scheme, interior_dtype))


def reset_launch_counts() -> None:
    """Set every launcher's ``launches`` count, and the shape logs, to 0."""
    for fn in LAUNCHERS:
        fn.launches = 0
    _SHAPES.clear()
    _VARIANTS.clear()


def launch_counts() -> dict:
    """``{launcher name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in LAUNCHERS}


def launch_shapes() -> dict:
    """``{(launcher name, problems, Lx, Ly, d, T): launches}`` since the last
    reset (problems is (Bx, By) for ``gram_fused``; d = 0 for the kernels
    that read a precomputed Δ; for ``fwd``, which has no strip, T is its
    geometry (R, warps))."""
    return dict(_SHAPES)


def launch_variants() -> dict:
    """``{launch_shapes() key: {(lam1, lam2, scheme, interior dtype)}}``
    since the last reset: what each shape's launches ran at."""
    return {k: set(v) for k, v in _VARIANTS.items()}


reset_launch_counts()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def solve_plain(delta: torch.Tensor, lam1: int, lam2: int, scheme: str,
                interior_dtype: str) -> torch.Tensor:
    """Plain version of :func:`fwd`: the vectorised anti-diagonal wavefront."""
    from repro_torch.core.sigkernel import _solve_antidiag
    stencil.check_scheme(scheme)
    stencil.check_interior_dtype(interior_dtype)
    return _solve_antidiag(delta, lam1, lam2, None, scheme, interior_dtype)


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


def _cell(p, left, up, upleft, k_dl, k_ul, edge, scheme: str, interior_dtype: str):
    """One cell of either stencil from its neighbours' values, in the
    kernels' order of operations and rounding (``stencil_cell`` in the CUDA
    source)."""
    if scheme == "order2":
        cur = ((left + up) * stencil.coeff_A(p) - upleft * stencil.coeff_B2_at(p, edge)
               - (k_dl + k_ul) * stencil.coeff_C2_at(p, edge))
    else:
        cur = (left + up) * stencil.coeff_A(p) - upleft * stencil.coeff_B1(p)
    return stencil.round_interior(cur, interior_dtype)


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
            cur = _cell(p, left, up, upleft, k_dl, k_ul, edge, scheme, interior_dtype)
        else:
            cur = _cell(p, left, up, upleft, None, None, None, scheme, interior_dtype)
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
    k = rows[:, nx - 1 - (S - 1) * T, ny - 1].contiguous()
    return k, torch.stack(cps, dim=1)


def fwd_wavefront_plain(delta: torch.Tensor, geo: FwdGeometry, lam1: int, lam2: int,
                        scheme: str, interior_dtype: str, T=None):
    """The precomputed-Δ forward's own schedule, in plain PyTorch: k̂[nx, ny]
    (B,) for Δ (B, Lx, Ly) at geometry ``geo`` and, given a strip height T,
    also the checkpoint rows of :func:`fwd_cps`, as ``(k, cps)``.

    As the kernel runs it (``goursat_fwd`` in the CUDA source): lane l of a
    warp owns rows l·R .. l·R+R−1 of its band of 32·R rows and at local step
    t computes their cells (l·R+i, t−l·R−i) from its own values of steps t−1
    and t−2 and, for its top row, lane l−1's (the shuffles; lane 0 reads the
    band above's bottom row(s) from the ring, or 1 on the first band).  Each
    chunk of CHUNK steps reads Δ staged with zeros off the grid.  The warps
    of a problem take bands w, w+warps, ...; each warp is a generator that
    yields while its mbarrier waits are not met (full before a chunk reads
    the ring, empty before it writes a slot of its own), and the warps run
    round-robin, so the rings' slot counts and phases are those of the
    kernel and a schedule that could deadlock raises.  Ring entries not yet
    written and checkpoint entries the kernel never writes are NaN, so a
    read or a row the kernel would miss shows in the result.
    """
    B, Lx, Ly = delta.shape
    nx, ny = Lx << lam1, Ly << lam2
    R, NW = geo.R, geo.warps
    K, RB = CHUNK, 32 * R
    D = RB // K
    n_bands, nrc = fwd_bands(nx, R), -(-ny // K)
    ns = [RING_SLOTS] * (NW - 1) + [fwd_last_slots(nx, ny, R, NW)]
    order2 = scheme == "order2"
    rows = cps_rows(scheme)
    dev, dt, nan = delta.device, delta.dtype, float("nan")
    m1, m2 = (1 << lam1) - 1, (1 << lam2) - 1
    scale = 2.0 ** -(lam1 + lam2)
    ring = [torch.full((B, n, 2, K), nan, dtype=dt, device=dev) for n in ns]
    full = [[0] * n for n in ns]     # phases each slot's full barrier completed
    empty = [[0] * n for n in ns]
    k_out = delta.new_full((B,), nan)
    cps = None
    if T is not None:
        S, W = n_strips(Lx, T, lam1), ny + T + 1
        cps = delta.new_full((B, S * rows, W), nan)
        cps[:, :rows] = 1.0                  # the constant entries, written up front
        cps[:, rows:, 0] = 1.0
        cps[:, rows:, ny + 1:] = 1.0
        if order2:
            cps[:, rows + 1::rows, ny + 1] = 0.0
    lr = torch.arange(32, device=dev)[:, None] * R          # (32, 1)
    ii = torch.arange(R, device=dev)
    ones = delta.new_ones(B, 32, R)

    def warp(w):
        wc = NW - 1 if w == 0 else w - 1
        for q, b in enumerate(range(w, n_bands, NW)):
            base = b * RB
            loc = lr + ii                                         # (32, R) rows of the band
            rho = base + loc
            M = -(-(ny + min(RB, nx - base) - 1) // K)
            consume, produce = b > 0, b + 1 < n_bands
            g_in, g_out = (q - 1 if w == 0 else q) * nrc, q * nrc
            edge_r = (rho & m1) == 0
            if T is not None:
                s1 = torch.where(((rho + 1) % T == 0) & ((rho + 1) // T < S), (rho + 1) // T, 0)
                s2 = torch.where(((rho + 2) % T == 0) & ((rho + 2) // T < S) & order2,
                                 (rho + 2) // T, 0)
            c1, c2, u1p = ones, ones, ones[:, :, 0]
            for m in range(M):
                ring_ok = consume and m < nrc
                if ring_ok:
                    g = g_in + m
                    while full[wc][g % ns[wc]] <= g // ns[wc]:
                        yield
                    r_in = ring[wc][:, g % ns[wc]]
                if produce and 0 <= m - D + 1 < nrc and g_out + m - D + 1 >= ns[w]:
                    g = g_out + m - D + 1
                    while empty[w][g % ns[w]] < g // ns[w]:
                        yield
                t = m * K + torch.arange(K, device=dev)[:, None, None]
                c = t - loc                                       # (K, 32, R) columns
                ok = (rho < nx) & (c >= 0) & (c < ny)
                P = delta[:, (rho >> lam1).clamp(max=Lx - 1), c.clamp(0, ny - 1) >> lam2]
                P = torch.where(ok, P, 0.0) * scale               # the staged chunk
                for k in range(K):
                    tk = m * K + k
                    if ring_ok:
                        top1, top2 = r_in[:, 0, k:k + 1], r_in[:, 1, k:k + 1]
                    else:
                        top1 = top2 = delta.new_ones(B, 1)
                    up1 = torch.cat([top1, c1[:, :-1, R - 1]], dim=1)            # (B, 32)
                    if order2:
                        send = c2[:, :, R - 2] if R >= 2 else u1p
                        up2 = torch.cat([top2, send[:, :-1]], dim=1)
                    up = torch.cat([up1[:, :, None], c1[:, :, :-1]], dim=2)
                    upleft = torch.cat([u1p[:, :, None], c2[:, :, :-1]], dim=2)
                    if order2:
                        k_ul = torch.cat([up2[:, :, None], u1p[:, :, None], c2[:, :, :-2]],
                                         dim=2)[:, :, :R]
                        edge = edge_r | (((tk - loc) & m2) == 0)
                        nw = _cell(P[:, k], c1, up, upleft, c2, k_ul, edge, scheme,
                                   interior_dtype)
                    else:
                        nw = _cell(P[:, k], c1, up, upleft, None, None, None, scheme,
                                   interior_dtype)
                    if produce:  # the band's bottom row(s) into the ring, column by column
                        for which, cb, v in ((0, tk - RB + 1, nw[:, 31, R - 1]),
                                             (1, tk - RB + 2, nw[:, 31 if R >= 2 else 30,
                                                                  R - 2 if R >= 2 else 0])):
                            if (which == 0 or order2) and 0 <= cb < ny:
                                g = g_out + cb // K
                                assert empty[w][g % ns[w]] >= g // ns[w], "slot still in use"
                                ring[w][:, g % ns[w], which, cb % K] = v
                    col = tk - loc
                    on = (col >= 0) & (col < ny)
                    if cps is not None:  # the lanes that own checkpoint rows
                        for srow, add in ((s1, 0), (s2, 1)):
                            sel = on & (srow > 0)
                            if sel.any():
                                cps[:, srow[sel] * rows + add, col[sel] + 1] = nw[:, sel]
                    hit = (rho == nx - 1) & (col == ny - 1)
                    if hit.any():
                        k_out.copy_(nw[:, hit][:, 0])
                    c2, c1, u1p = c1, nw, up1
                if ring_ok:
                    empty[wc][(g_in + m) % ns[wc]] += 1
                if produce and 0 <= m - D < nrc:
                    full[w][(g_out + m - D) % ns[w]] += 1
            if produce:
                for j in range(max(0, M - D), nrc):
                    full[w][(g_out + j) % ns[w]] += 1

    running = [warp(w) for w in range(min(NW, n_bands))]
    while running:  # round-robin; a round in which no warp moves is a deadlock
        before = sum(map(sum, full)) + sum(map(sum, empty)), len(running)
        for gen in list(running):
            if next(gen, StopIteration) is StopIteration:
                running.remove(gen)
        if running and (sum(map(sum, full)) + sum(map(sum, empty)), len(running)) == before:
            raise RuntimeError(f"forward schedule deadlocks at geometry {geo}")
    return k_out if T is None else (k_out, cps)


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
