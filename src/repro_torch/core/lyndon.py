"""Lyndon-word machinery for log-signatures (free Lie algebra bases).

Counterpart of ``repro/core/lyndon.py``, with its own copy of the numpy
part (Duval enumeration, Witt's formula, the standard bracketing, the
expansion matrix and the word/bracket change of basis).  The log-signature
lives in the free Lie algebra, whose dimension is the number of Lyndon words
of length <= N.  Two coordinate systems:

* ``"lyndon"`` — the coefficient of each Lyndon *word* read off the flat
  tensor expansion (an ``index_select``);
* ``"brackets"`` — coefficients in the Lyndon bracket basis, recovered from
  the word coefficients by the precomputed inverse of the unitriangular
  change of basis (a matmul).

Data-independent tables are computed once per (d, depth) in numpy; their
tensors are cached per (d, depth, dtype, device).  Ordering: by length,
lexicographic within a length, matching the flat level layout of
:mod:`repro_torch.core.tensoralg`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from .tensoralg import level_offsets, sig_dim

Word = Tuple[int, ...]


# ---------------------------------------------------------------------------
# enumeration (Duval's algorithm) and Witt's formula
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lyndon_words(d: int, depth: int) -> Tuple[Word, ...]:
    """All Lyndon words over {0..d-1} of length 1..depth, (length, lex)-ordered."""
    by_len: List[List[Word]] = [[] for _ in range(depth + 1)]
    w = [-1]
    while w:
        w[-1] += 1
        m = len(w)
        by_len[m].append(tuple(w))
        while len(w) < depth:
            w.append(w[len(w) - m])
        while w and w[-1] == d - 1:
            w.pop()
    return tuple(wd for length in range(1, depth + 1) for wd in sorted(by_len[length]))


def _mobius(n: int) -> int:
    if n == 1:
        return 1
    mu, m = 1, n
    p = 2
    while p * p <= m:
        if m % p == 0:
            m //= p
            if m % p == 0:
                return 0
            mu = -mu
        p += 1
    if m > 1:
        mu = -mu
    return mu


def witt_dims(d: int, depth: int) -> List[int]:
    """Number of Lyndon words of each length 1..depth (Witt's formula)."""
    out = []
    for n in range(1, depth + 1):
        total = sum(_mobius(m) * d ** (n // m) for m in range(1, n + 1) if n % m == 0)
        out.append(total // n)
    return out


def logsig_dim(d: int, depth: int) -> int:
    """Dimension of the depth-truncated free Lie algebra over R^d."""
    return sum(witt_dims(d, depth))


# ---------------------------------------------------------------------------
# standard bracketing and its tensor expansion
# ---------------------------------------------------------------------------

def _is_lyndon(w: Word) -> bool:
    return all(w < w[i:] + w[:i] for i in range(1, len(w)))


@functools.lru_cache(maxsize=None)
def standard_bracketing(w: Word):
    """Chen-Fox-Lyndon bracketing: w = uv with v the longest proper Lyndon
    suffix; returns a nested tuple of letters."""
    if len(w) == 1:
        return w[0]
    if not _is_lyndon(w):
        raise ValueError(f"not a Lyndon word: {w}")
    for i in range(1, len(w)):
        if _is_lyndon(w[i:]):
            return (standard_bracketing(w[:i]), standard_bracketing(w[i:]))
    raise AssertionError("unreachable: every Lyndon word factorises")


def bracket_string(w: Word) -> str:
    """Human-readable standard bracketing, e.g. ``[0, [0, 1]]``."""
    def fmt(b):
        if isinstance(b, int):
            return str(b)
        return f"[{fmt(b[0])}, {fmt(b[1])}]"
    return fmt(standard_bracketing(w))


def _expand_bracket(b) -> Dict[Word, float]:
    """Tensor-word coefficients of a nested commutator ``[u, v] = uv - vu``."""
    if isinstance(b, int):
        return {(b,): 1.0}
    u, v = _expand_bracket(b[0]), _expand_bracket(b[1])
    out: Dict[Word, float] = {}
    for wu, cu in u.items():
        for wv, cv in v.items():
            out[wu + wv] = out.get(wu + wv, 0.0) + cu * cv
            out[wv + wu] = out.get(wv + wu, 0.0) - cu * cv
    return {w: c for w, c in out.items() if c != 0.0}


def word_to_flat_index(w: Word, d: int, depth: int) -> int:
    """Position of tensor word w inside the flat level-1..depth layout."""
    within = 0
    for a in w:
        within = within * d + a
    return level_offsets(d, depth)[len(w) - 1] + within


# ---------------------------------------------------------------------------
# cached static tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lyndon_flat_indices(d: int, depth: int) -> np.ndarray:
    """Flat-layout index of every Lyndon word — the "final gather" table."""
    return np.asarray([word_to_flat_index(w, d, depth) for w in lyndon_words(d, depth)],
                      dtype=np.int32)


@functools.lru_cache(maxsize=None)
def expand_matrix(d: int, depth: int) -> np.ndarray:
    """E (n_lyndon, sig_dim): row i is the tensor expansion of bracket i."""
    words = lyndon_words(d, depth)
    E = np.zeros((len(words), sig_dim(d, depth)), dtype=np.float64)
    for i, w in enumerate(words):
        for tw, c in _expand_bracket(standard_bracketing(w)).items():
            E[i, word_to_flat_index(tw, d, depth)] = c
    return E


@functools.lru_cache(maxsize=None)
def _basis_change(d: int, depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """(M, M^{-1}) with M[i, j] = coeff of Lyndon word i in bracket j.

    The entries of ``expand_matrix(d, depth)[:, lyndon_flat_indices].T``,
    read straight off the bracket expansions, so the (n_lyndon, sig_dim)
    matrix E is never built for it.  With (length, lex) ordering M is
    block-diagonal by length and lower-unitriangular within each block,
    hence exactly invertible.  A bracket's expansion only rearranges the
    letters of its word, so M is block-diagonal by the words' letter
    multisets too (finer blocks of at most a few dozen words): M^{-1} is
    one unit-triangular solve a block, with the blocks of one size solved
    together, never a dense inverse of the (n_lyndon, n_lyndon) matrix.
    The entries of M are integers, and so are the solves' results.
    """
    words = lyndon_words(d, depth)
    pos = {w: i for i, w in enumerate(words)}
    M = np.zeros((len(words), len(words)), dtype=np.float64)
    blocks: Dict[Word, List[int]] = {}
    for j, w in enumerate(words):
        content = tuple(sorted(w))
        blocks.setdefault(content, []).append(j)
        for tw, c in _expand_bracket(standard_bracketing(w)).items():
            if tw in pos:
                assert tuple(sorted(tw)) == content
                M[pos[tw], j] = c
    by_size: Dict[int, List[List[int]]] = {}
    for idx in blocks.values():
        by_size.setdefault(len(idx), []).append(idx)
    Minv = np.zeros_like(M)
    for size, groups in by_size.items():
        idx = np.asarray(groups)                       # (G, size), rows increasing
        rows, cols = idx[:, :, None], idx[:, None, :]
        sub = M[rows, cols]                            # (G, size, size)
        assert np.all(np.diagonal(sub, axis1=1, axis2=2) == 1.0)
        assert not np.triu(sub, 1).any()
        eye = torch.eye(size, dtype=torch.float64).expand(len(groups), size, size)
        Minv[rows, cols] = torch.linalg.solve_triangular(
            torch.from_numpy(sub), eye, upper=False, unitriangular=True).numpy()
    return M, Minv


@functools.lru_cache(maxsize=None)
def _cached(name: str, d: int, depth: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """A static table as a tensor, once per (d, depth, dtype, device)."""
    if name == "indices":
        return torch.from_numpy(lyndon_flat_indices(d, depth).astype(np.int64)).to(device)
    if name == "minv_t":
        return torch.from_numpy(np.ascontiguousarray(_basis_change(d, depth)[1].T)).to(
            device=device, dtype=dtype)
    if name == "expand":
        return torch.from_numpy(expand_matrix(d, depth)).to(device=device, dtype=dtype)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# compress / expand maps
# ---------------------------------------------------------------------------

def compress(logsig_flat: torch.Tensor, d: int, depth: int,
             mode: str = "lyndon") -> torch.Tensor:
    """Project a flat log-signature (..., sig_dim) onto Lie coordinates
    (..., logsig_dim): the Lyndon-word coefficients (``"lyndon"``), times the
    inverse change of basis for ``"brackets"``."""
    dev, dt = logsig_flat.device, logsig_flat.dtype
    words = torch.index_select(logsig_flat, -1, _cached("indices", d, depth, dt, dev))
    if mode == "lyndon":
        return words
    if mode == "brackets":
        return words @ _cached("minv_t", d, depth, dt, dev)
    raise ValueError(f"unknown compress mode: {mode!r}")


def expand(coeffs: torch.Tensor, d: int, depth: int, mode: str = "lyndon") -> torch.Tensor:
    """Inverse of :func:`compress`: Lie coordinates (..., logsig_dim) back to
    the flat tensor layout (..., sig_dim)."""
    dev, dt = coeffs.device, coeffs.dtype
    if mode == "lyndon":
        coeffs = coeffs @ _cached("minv_t", d, depth, dt, dev)
    elif mode != "brackets":
        raise ValueError(f"unknown expand mode: {mode!r}")
    return coeffs @ _cached("expand", d, depth, dt, dev)
