"""The Hopper Horner kernel for truncated signatures, and its plain version.

The CUDA C++ lives in ``csrc/signature.cu`` (its header comment gives the
design, what bounds the kernel on an H100 and what the design does about
it).  It is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/`` beside this module
(:mod:`repro_torch.kernels._build`), and loaded with ``ctypes``.

One launcher, for the one Pallas kernel it replaces:

=================  =================================================
``horner``         ``repro/kernels/signature/kernel.py:horner_kernel``
=================  =================================================

It takes CUDA float32 increments (B, n, d), allocates the (B, sig_dim)
output with ``torch.empty``, launches one block per path on the current
stream and adds one to its ``launches`` count.  Its plain version,
:func:`horner_plain`, is the Horner scan of :mod:`repro_torch.core.signature`
in the kernel's order of operations (true divisions, every operation rounded
on its own), so on the card the two agree bit for bit.  The wrapper in
``ops.py`` takes the plain version for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.core.tensoralg import sig_dim

from .. import _build

_SRC = Path(__file__).resolve().parent / "csrc" / "signature.cu"

#: deepest truncation the kernel takes (kMaxDepth in the CUDA source)
MAX_DEPTH = 16
#: threads per block
MAX_THREADS = 1024
#: dynamic shared memory one block may use on an H100: the 227 KB opt-in
#: less the kernel's static level tables
SMEM_LIMIT = 232448 - 2 * 4 * (MAX_DEPTH + 1)

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the built library lives: keyed by the source and the flags."""
    return _build.library_path(_SRC, "signature")


def build() -> Path:
    """Compile the kernel unless this source was already built; return the
    library path (``nvcc.log`` beside it keeps the ptxas report)."""
    return _build.build(_SRC, "signature")


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.signature_horner.argtypes = [p, p, ll, i, i, i, i, i, ll, p]
            lib.signature_horner.restype = ctypes.c_int
            lib.signature_error_string.argtypes = [ctypes.c_int]
            lib.signature_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def smem_bytes(d: int, depth: int, S: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_floats`` in the
    CUDA source, which checks it): levels 1..N-1, the S staged increments,
    z/m for m = 2..N, two Horner buffers of d^(N-2) (N >= 4) and the S
    staged U_t = B_N + A_{N-1} of d^(N-1) each (N >= 2)."""
    n = sum(d ** k for k in range(1, depth)) + S * d + (depth - 1) * d
    if depth >= 4:
        n += 2 * d ** (depth - 2)
    if depth >= 2:
        n += S * d ** (depth - 1)
    return 4 * n


def horner_flops(d: int, depth: int) -> int:
    """Operations of one Horner step of one path, as the plain scan counts
    them: per level k the k−1 divisions z/m, the adds and tensor products
    of the accumulator, then (B + A_{k-1}) ⊗ z + A_k; then A_1 + z."""
    n = d
    for k in range(2, depth + 1):
        n += d                                               # z / k
        n += sum(d ** i + d ** (i + 1) + d for i in range(1, k - 1))
        n += d ** (k - 1) + 2 * d ** k
    return n


def _check(z: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"z must be a CUDA tensor, got device {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"z must be float32, got {z.dtype}")
    if z.dim() != 3:
        raise ValueError(f"z must be (B, n, d), got shape {tuple(z.shape)}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")


def horner(z: torch.Tensor, depth: int, S: int, threads: int) -> torch.Tensor:
    """Signatures (B, sig_dim) of increments z (B, n, d) on the card: one
    block of ``threads`` per path, S increments staged per length block."""
    _check(z)
    B, n, d = z.shape
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} outside the kernel's 1..{MAX_DEPTH}")
    if threads < 32 or threads > MAX_THREADS or threads % 32:
        raise ValueError(f"threads={threads} must be a multiple of 32 in [32, "
                         f"{MAX_THREADS}]")
    smem = smem_bytes(d, depth, S)
    if S < 1 or smem > SMEM_LIMIT:
        raise ValueError(
            f"Horner kernel needs {smem} bytes of shared memory per block (d={d}, "
            f"depth={depth}, S={S}), above the {SMEM_LIMIT}-byte limit of one "
            f"H100 block")
    out = torch.empty(B, sig_dim(d, depth), device=z.device, dtype=torch.float32)
    if B == 0 or n == 0:
        return out.zero_()
    with torch.cuda.device(z.device):
        err = library().signature_horner(
            z.data_ptr(), out.data_ptr(), B, n, d, depth, S, threads, smem,
            torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        name = library().signature_error_string(err).decode()
        raise RuntimeError(f"Horner kernel launch failed: CUDA error {err} ({name})")
    horner.launches += 1
    return out


LAUNCHERS = (horner,)


def reset_launch_counts() -> None:
    """Set every launcher's ``launches`` count to 0."""
    for fn in LAUNCHERS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{launcher name: launches}`` since the last reset."""
    return {fn.__name__: fn.launches for fn in LAUNCHERS}


reset_launch_counts()


def horner_plain(z: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain version of :func:`horner`: the Horner scan over z (B, n, d)."""
    from repro_torch.core.signature import _signature_horner_from_increments
    return _signature_horner_from_increments(z, depth)
