"""Hopper kernels for the Goursat-PDE signature-kernel forward, and their
plain PyTorch versions.

The CUDA C++ lives in ``csrc/sigkernel_pde.cu`` (its header comment gives
the design, what bounds each kernel on an H100 and what the design does
about it).  It is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, keyed by a hash of the source and
the flags, under ``build/`` beside this module, and loaded with ``ctypes``.

Three launchers, one per replaced Pallas kernel of the JAX package:

=================  =================================================
``fwd``            ``repro/kernels/sigkernel_pde/kernel.py:fwd_kernel``
                   (+ ``_wavefront``), without checkpoint rows
``fwd_fused``      ``kernel.py:fused_fwd_kernel``
``gram_fused``     ``kernel.py:fused_gram_kernel``
=================  =================================================

Each launcher takes CUDA float32 tensors only, allocates its output with
``torch.empty``, launches on the current stream and adds one to its
``launches`` count.  Beside each is its plain version (``solve_plain``,
``solve_fused_plain``, ``gram_fused_plain``): the vectorised anti-diagonal
wavefront of :mod:`repro_torch.core.sigkernel`, with Δ built by ``einsum``
for the fused pair.  The kernels round every operation as these elementwise
ops do and take the fused dot product in float64, as
:func:`stencil.delta_einsum` does, so on the card each kernel matches its
plain version bit for bit in practice (chip_smoke.py checks it).  The
wrappers in ``ops.py`` take the plain version for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import stencil

_SRC = Path(__file__).resolve().parent / "csrc" / "sigkernel_pde.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: shared memory one block may use on an H100 (opt-in, 227 KB)
SMEM_LIMIT = 232448
#: threads per block
MAX_THREADS = 1024
#: wavefront steps whose Δ entries a thread gathers at once (kGroup in the
#: CUDA source)
GROUP = 8

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the Goursat kernels "
            "are built from csrc/sigkernel_pde.cu at first use")
    return found


def library_path() -> Path:
    """Where the built library lives: keyed by the source and the flags."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / key.hexdigest()[:16] / "libsigkernel_pde.so"


def build() -> Path:
    """Compile the kernels unless this source was already built; return the
    library path.  The compiler's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept in ``nvcc.log`` beside it."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    (path.parent / "nvcc.log").write_text(done.stdout + done.stderr)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}):\n{done.stderr}")
    os.replace(tmp, path)
    return path


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
            for fn in (lib.sigkernel_pde_fwd, lib.sigkernel_pde_fwd_fused,
                       lib.sigkernel_pde_gram_fused):
                fn.restype = ctypes.c_int
            lib.sigkernel_pde_error_string.argtypes = [ctypes.c_int]
            lib.sigkernel_pde_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def smem_bytes(fused: bool, scheme: str, T: int, Ly: int, lam1: int, lam2: int,
               d: int = 0) -> int:
    """Shared memory one block takes: the carried boundary row(s) of length
    ny+T+1 and three anti-diagonals of T floats, and for the fused kernels
    the strip's R = T >> lam1 rows of dx and a ring of T + GROUP rows of dy,
    as float64 at odd stride (mirrors ``smem_bytes`` in the CUDA source,
    which checks it)."""
    rows = 2 if scheme == "order2" else 1
    n = 4 * (rows * ((Ly << lam2) + T + 1) + 3 * T)
    if fused:
        n += 8 * ((T >> lam1) + T + GROUP) * (d | 1)
    return n


def check_strip(T: int, lam1: int, scheme: str) -> None:
    """Validate a strip height for the kernels; raise ValueError otherwise."""
    if T < 2 or T > MAX_THREADS or T & (T - 1) or (T >> lam1) < 1:
        raise ValueError(
            f"Goursat strip height T={T} must be a power of two in "
            f"[max(2, 2**lam1={1 << lam1}), {MAX_THREADS}] (one thread per "
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
    if t.requires_grad:
        raise NotImplementedError(
            f"{name} requires grad: the Goursat kernels are forward only "
            f"until the exact backward lands (ROADMAP item B2)")


def _launch(fn, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        name = library().sigkernel_pde_error_string(err).decode()
        raise RuntimeError(f"Goursat kernel launch failed: CUDA error {err} ({name})")
    return out


def _smem_checked(fused, scheme, T, Ly, lam1, lam2, d=0) -> int:
    check_strip(T, lam1, scheme)
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
    return out


LAUNCHERS = (fwd, fwd_fused, gram_fused)


def reset_launch_counts() -> None:
    """Set every launcher's ``launches`` count to 0."""
    for fn in LAUNCHERS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{launcher name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in LAUNCHERS}


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
