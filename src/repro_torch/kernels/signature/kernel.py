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
output with ``torch.empty``, launches one block per path and prefix of p
first indices (the signature splits into such slices exactly, see the CUDA
source) on the current stream and adds one to its ``launches`` count.  Its plain version,
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
#: threads per block (kMaxThreads in the CUDA source: its launch bound holds
#: two such blocks an SM, 64 registers a thread)
MAX_THREADS = 512
#: top-level entries each thread keeps in registers (kTop in the CUDA source)
TOP = 16
#: floats per staged row of TOP entries of U_t (kTile in the CUDA source)
TILE = TOP + 4
#: dynamic shared memory one block may use on an H100: the 227 KB opt-in
#: less the kernel's static tables (412 bytes)
SMEM_LIMIT = 232448 - 512

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
            lib.signature_horner.argtypes = [p, p, ll, i, i, i, i, i, i, i, i, ll, p]
            lib.signature_horner.restype = ctypes.c_int
            lib.signature_error_string.argtypes = [ctypes.c_int]
            lib.signature_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def top_rows(d: int, depth: int, p: int) -> int:
    """Rows of the top level's slice at prefix length p: U_t has d^(N-1-p)
    entries (1 at N = 1, where the top level is A_1 and U_t = 1)."""
    return d ** (depth - 1 - p) if depth >= 2 else 1


#: entries of a lower-level row each work item takes, at most (kChunk in
#: the CUDA source); a launch's chunk width cw is 1, 2 or 4
CHUNK = 4


def row_items(d: int, depth: int, p: int, cw: int) -> int:
    """Work items of one step below the top level (``row_items`` in the CUDA
    source): for each task (A_1, A_2..A_{N-1}, U_t) its rows, the entries
    that differ in their last index only, cut into ceil(d / cw) chunks."""
    if depth == 1:
        return 1
    n = 0
    for k in range(1, depth + 1):
        m = 0 if k == 1 else (k - 1 if k < depth else depth - 2)
        lvl = k if k < depth else depth - 1
        n += d ** max(0, m - p) * (-(-d // cw) if lvl > p else 1)
    return n


def _warps(n: int) -> int:
    return -(-n // 32) * 32


def row_stride(w: int, cw: int) -> int:
    """Shared-memory stride of a row of w entries (``row_stride`` in the
    CUDA source): its ceil(w / cw) chunk threads times the least odd u that
    holds the row, so a warp's rows start on distinct banks."""
    nch = -(-w // cw)
    u = -(-w // nch)
    return nch * (u + 1 - u % 2)


def smem_bytes(d: int, depth: int, p: int, cw: int, S: int, threads: int) -> int:
    """Dynamic shared memory of one block (mirrors ``smem_floats`` in the
    CUDA source, which checks it): U_t of two steps in tiles of TOP rows at
    a stride of TILE, the threads' Horner chain offsets (two ints a stage,
    N-3 stages), two buffers of the slices of
    levels 1..N-1 (rows of d entries at ``row_stride(d, cw)``), the S staged
    increments and their z/m for m = 2..N."""
    tiles = -(-top_rows(d, depth, p) // TOP)
    lower = sum(1 if k <= p else d ** (k - 1 - p) * row_stride(d, cw)
                for k in range(1, depth))
    chain = 2 * max(0, depth - 3) * threads
    return 4 * (2 * tiles * TILE + chain + 2 * lower + S * d + S * (depth - 1) * d)


def threads_needed(d: int, depth: int, p: int, jw: int, cw: int) -> int:
    """Threads of a block: one a row item of the step and one a tile of TOP
    top-level rows of one of the jw columns, whichever needs more, in whole
    warps."""
    return _warps(max(row_items(d, depth, p, cw), jw * -(-top_rows(d, depth, p) // TOP)))


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


def horner(z: torch.Tensor, depth: int, p: int, jw: int, cw: int, S: int,
           threads: int) -> torch.Tensor:
    """Signatures (B, sig_dim) of increments z (B, n, d) on the card: one
    block of ``threads`` per path, prefix of p first indices and chunk of
    jw top-level columns, lower-level rows in chunks of cw entries, S
    increments staged per length block (the geometry of
    :func:`repro_torch.kernels.signature.ops.geometry`)."""
    _check(z)
    B, n, d = z.shape
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} outside the kernel's 1..{MAX_DEPTH}")
    if not 0 <= p <= max(depth - 1, 0) or not 1 <= jw <= d or not 1 <= cw <= CHUNK \
            or S < 1:
        raise ValueError(f"bad Horner geometry p={p}, jw={jw}, cw={cw}, S={S} for "
                         f"d={d}, depth={depth}")
    need = threads_needed(d, depth, p, jw, cw)
    if threads % 32 or not need <= threads <= MAX_THREADS:
        raise ValueError(f"threads={threads} must be a multiple of 32 in "
                         f"[{need}, {MAX_THREADS}]")
    smem = smem_bytes(d, depth, p, cw, S, threads)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"Horner kernel needs {smem} bytes of shared memory per block (d={d}, "
            f"depth={depth}, p={p}, S={S}), above the {SMEM_LIMIT}-byte limit of one "
            f"H100 block")
    out = torch.empty(B, sig_dim(d, depth), device=z.device, dtype=torch.float32)
    if B == 0 or n == 0:
        return out.zero_()
    with torch.cuda.device(z.device):
        err = library().signature_horner(
            z.data_ptr(), out.data_ptr(), B, n, d, depth, p, jw, cw, S, threads, smem,
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


def _slice_digits(d: int, prefix, m: int) -> torch.Tensor:
    """(d^max(0, m-p), m) digits of the entries of level m that begin with
    ``prefix`` (p digits; all of them when m <= p), in flat order."""
    p = len(prefix)
    if m <= p:
        return torch.tensor([list(prefix[:m])], dtype=torch.long)
    rest = torch.cartesian_prod(*[torch.arange(d)] * (m - p)).reshape(-1, m - p)
    head = torch.tensor(list(prefix), dtype=torch.long).expand(rest.shape[0], p)
    return torch.cat([head, rest], dim=1)


def _flat_index(digits: torch.Tensor, d: int) -> torch.Tensor:
    """Flat index within a level of (n, m) digits."""
    w = d ** torch.arange(digits.shape[1] - 1, -1, -1)
    return (digits * w).sum(1)


def horner_slice_plain(z: torch.Tensor, depth: int, prefix) -> list:
    """One slice of the signature by the kernel's split scan: the entries of
    levels 1..N of increments z (B, n, d) that begin with ``prefix`` (p
    first indices; at levels k <= p the one entry prefix[:k]), as a list of
    (B, d^max(0, k-p)) tensors in flat order.  Per step, from the old
    levels: Y_k = B_{k-2} + A_{k-2} by the Horner chain from z/k (k >= 3),
    then A_k = (Y_k ⊗ z/2 + A_{k-1}) ⊗ z + A_k, A_2 = (z/2 + A_1) ⊗ z + A_2,
    A_1 = A_1 + z, and the top level U_t ⊗ z + A_N with U_t = Y_N ⊗ z/2 +
    A_{N-1} (U_t = z/2 + A_1 at N = 2, A_1 + z at N = 1): every entry by the
    operations of :func:`horner_plain`, in its order, so the slices
    assembled (:func:`horner_split_plain`) equal it bit for bit."""
    from repro_torch.core.tensoralg import divide
    B, n, d = z.shape
    N = depth
    dig = {m: _slice_digits(d, prefix, m) for m in range(1, N + 1)}
    # local index, in the level-len slice, of each entry's first len digits
    local = {m: {ln: _flat_index(dig[m][:, len(prefix):ln], d)
                 if ln > len(prefix) else torch.zeros(len(dig[m]), dtype=torch.long)
                 for ln in range(1, m + 1)} for m in range(1, N + 1)}
    lv = [None] + [z.new_zeros(B, len(dig[k])) for k in range(1, N + 1)]
    for t in range(n):
        zt = z[:, t]
        zq = {m: divide(zt, m) for m in range(2, N + 1)}
        Y = {}
        for k in range(3, N + 1):
            m = k - 2
            b = zq[k][:, dig[m][:, 0]]
            for i in range(1, m):
                b = (b + lv[i][:, local[m][i]]) * zq[k - i][:, dig[m][:, i]]
            Y[k] = b + lv[m]
        new = list(lv)
        if N == 1:
            new[1] = zt[:, dig[1][:, 0]] + lv[1]
        for k in range(2, N + 1):
            if k == 2:
                b = zq[2][:, dig[2][:, 0]]
            else:
                b = Y[k][:, local[k][k - 2]] * zq[2][:, dig[k][:, k - 2]]
            b = b + lv[k - 1][:, local[k][k - 1]]
            new[k] = b * zt[:, dig[k][:, k - 1]] + lv[k]
        if N >= 2:
            new[1] = lv[1] + zt[:, dig[1][:, 0]]
        lv = new
    return lv[1:]


def horner_split_plain(z: torch.Tensor, depth: int, p: int) -> torch.Tensor:
    """Signatures (B, sig_dim) assembled from the d^p slices of
    :func:`horner_slice_plain`, as the kernel's blocks assemble them."""
    B, n, d = z.shape
    out = z.new_empty(B, sig_dim(d, depth))
    off = [0]
    for k in range(1, depth + 1):
        off.append(off[-1] + d ** k)
    for prefix in (torch.cartesian_prod(*[torch.arange(d)] * p).reshape(-1, p).tolist()
                   if p else [[]]):
        for k, level in enumerate(horner_slice_plain(z, depth, prefix), start=1):
            idx = _flat_index(_slice_digits(d, prefix, k), d)
            out[:, off[k - 1] + idx] = level
    return out
