"""Gradients of the port's Gram engine, its streaming reduction and the
losses, against the JAX package's.

Seeded numpy inputs go through ``jax.value_and_grad`` of the JAX package
(its ``reference``/``antidiag`` backward; the CPU's ``auto`` picks them) and
``torch.autograd`` of the port, in float64, where the two do the same
arithmetic: tolerance 1e-10 relative to the largest JAX entry.  The
streaming paths (``sigkernel_gram_reduce``, ``mmd2``/``scoring_rule`` with
``row_block=``) are held to the JAX package's dense values and gradients as
well: the two differ only in the order of the sums.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro_torch.core import dispatch

jgram = importlib.import_module("repro.core.gram")
jlosses = importlib.import_module("repro.core.losses")
tlosses = importlib.import_module("repro_torch.core.losses")

RTOL = 1e-10


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def paths(seed, B, L, d=2):
    return np.cumsum(np.random.default_rng(seed).normal(size=(B, L, d)) * 0.4, axis=1)


#: (JAX config kwargs, the port's)
CONFIGS = {
    "linear": (dict(), dict()),
    "order2_lam11": (dict(grid=repro.GridConfig(1, 1, scheme="order2")),
                     dict(grid=rt.GridConfig(1, 1, scheme="order2"))),
    "rbf": (dict(static_kernel=repro.RBF(0.8), grid=repro.GridConfig(0, 1)),
            dict(static_kernel=rt.RBF(0.8), grid=rt.GridConfig(0, 1))),
}


def _leaves(*arrays):
    return [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrays]


# ---------------------------------------------------------------------------
# the Gram engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_gram(name, symmetric):
    X, Y = paths(1, 4, 6), paths(2, 3, 5)
    W = np.random.default_rng(3).normal(size=(4, 4 if symmetric else 3))
    jkw = CONFIGS[name][0]
    with jax.enable_x64(True):
        def f(a, b):
            return (jgram.sigkernel_gram(a, b, **jkw) * jnp.asarray(W)).sum()
        if symmetric:
            v, g = jax.value_and_grad(lambda a: f(a, None))(jnp.asarray(X))
            grads = [np.asarray(g)]
        else:
            v, gs = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(X), jnp.asarray(Y))
            grads = [np.asarray(g) for g in gs]
    return X, (None if symmetric else Y), W, float(v), grads


@pytest.mark.parametrize("mode", ["dense", "row_block", "symmetric"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gram_grad_matches_jax(name, mode):
    X, Y, W, want_v, want_g = _jax_gram(name, mode == "symmetric")
    leaves = _leaves(X, Y)
    kw = {"row_block": 2} if mode == "row_block" else {}
    K = rt.sigkernel_gram(*leaves, **kw, **CONFIGS[name][1])
    v = (K * torch.from_numpy(W)).sum()
    v.backward()
    close(v.detach(), want_v)
    for leaf, g in zip([t for t in leaves if t is not None], want_g):
        close(leaf.grad, g)


# ---------------------------------------------------------------------------
# sigkernel_gram_reduce
# ---------------------------------------------------------------------------

REDUCE_CASES = {
    "rows": dict(Y=True, row_block=2),
    "rows_ragged": dict(Y=True, row_block=2, lengths=True),
    "symmetric": dict(Y=False, row_block=1),
    "symmetric_no_diag": dict(Y=False, row_block=1, include_diag=False),
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_gram_reduce_matches_jax(case):
    spec = REDUCE_CASES[case]
    X, Y = paths(6, 5, 6), (paths(7, 3, 5) if spec["Y"] else None)
    kw = dict(row_block=spec["row_block"])
    if "include_diag" in spec:
        kw["include_diag"] = spec["include_diag"]
    if spec.get("lengths"):
        kw.update(lengths=np.array([6, 3, 5, 2, 4]), lengths_y=np.array([5, 4, 2]))
    jkw, tkw = CONFIGS["order2_lam11"]
    argnums = (0, 1) if Y is not None else (0,)
    with jax.enable_x64(True):
        args = [jnp.asarray(X)] + ([] if Y is None else [jnp.asarray(Y)])
        want_v, want_g = jax.value_and_grad(
            lambda *a: jgram.sigkernel_gram_reduce(*a, **kw, **jkw), argnums=argnums)(*args)
    leaves = [t for t in _leaves(X, Y) if t is not None]
    with dispatch.count_pair_solves() as c:
        v = rt.sigkernel_gram_reduce(*leaves, **kw, **tkw)
    v.backward()
    close(v.detach(), want_v)
    for leaf, g in zip(leaves, want_g):
        close(leaf.grad, g)
    assert c.total == (5 * 3 if Y is not None else 5 * 6 // 2)


@pytest.mark.parametrize("row_block", [1, 2, 5])
def test_gram_reduce_equals_the_gram_sum(row_block):
    """Value and gradient of the streamed sum equal the dense Gram's sum,
    whatever the block; the symmetric sum without the diagonal is Σ − tr."""
    X, Y = paths(8, 5, 5), paths(9, 3, 6)
    tX, tY = _leaves(X, Y)
    red = (rt.sigkernel_gram_reduce(tX, tY, row_block=row_block)
           + rt.sigkernel_gram_reduce(tX, row_block=row_block, include_diag=False))
    gX, gY = torch.autograd.grad(red, (tX, tY))
    Kxx = rt.sigkernel_gram(tX)
    dense = rt.sigkernel_gram(tX, tY).sum() + Kxx.sum() - torch.trace(Kxx)
    wX, wY = torch.autograd.grad(dense, (tX, tY))
    close(red.detach(), dense.detach(), 1e-13)
    close(gX, wX, 1e-13)
    close(gY, wY, 1e-13)


def test_gram_reduce_include_diag_needs_the_symmetric_sum():
    X = torch.from_numpy(paths(10, 3, 4))
    with pytest.raises(ValueError, match="symmetric"):
        rt.sigkernel_gram_reduce(X, X, include_diag=False)


def test_streaming_reduce_keeps_no_dense_gram_for_the_backward():
    """What autograd keeps for the backward: the dense Gram's pairwise
    streams of all Bx·By pairs, the streamed reduction only each block's
    inputs (the blocks are recomputed under torch.utils.checkpoint)."""
    X, Y = paths(11, 8, 6), paths(12, 8, 6)

    def largest_saved(fn):
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        tX, tY = _leaves(X, Y)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(tX, tY)
        out.backward()
        return max(sizes)

    dense = largest_saved(lambda a, b: rt.sigkernel_gram(a, b).sum())
    streamed = largest_saved(lambda a, b: rt.sigkernel_gram_reduce(a, b, row_block=2))
    assert dense >= 8 * 8 * 5 * 5          # a (Bx, By, Lx, Ly) pairwise Δ
    assert streamed <= X.size              # no more than one batch of paths


# ---------------------------------------------------------------------------
# losses, streaming and not
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [None, True, False])
def test_use_streaming_rule_matches_jax(streaming):
    for row_block in (None, 4):
        assert tlosses._use_streaming(streaming, row_block) \
            == jlosses._use_streaming(streaming, row_block)


@functools.lru_cache(maxsize=None)
def _jax_mmd2(unbiased):
    X, Y = paths(13, 4, 6), paths(14, 3, 5)
    with jax.enable_x64(True):
        v, g = jax.value_and_grad(lambda a, b: jlosses.mmd2(a, b, unbiased=unbiased),
                                  argnums=(0, 1))(jnp.asarray(X), jnp.asarray(Y))
    return X, Y, float(v), [np.asarray(t) for t in g]


@pytest.mark.parametrize("unbiased", [True, False])
@pytest.mark.parametrize("streaming", [False, True])
def test_mmd2_grad_matches_jax(streaming, unbiased):
    X, Y, want_v, want_g = _jax_mmd2(unbiased)
    tX, tY = _leaves(X, Y)
    kw = {"row_block": 2} if streaming else {}
    v = rt.mmd2(tX, tY, unbiased=unbiased, **kw)
    v.backward()
    close(v.detach(), want_v)
    close(tX.grad, want_g[0])
    close(tY.grad, want_g[1])


@functools.lru_cache(maxsize=None)
def _jax_scoring_rule():
    X, y = paths(15, 4, 6), paths(16, 1, 7)[0]
    jkw = CONFIGS["order2_lam11"][0]
    with jax.enable_x64(True):
        v, g = jax.value_and_grad(
            lambda a, b: jlosses.scoring_rule(a, b, length_y=5, **jkw),
            argnums=(0, 1))(jnp.asarray(X), jnp.asarray(y))
    return X, y, float(v), [np.asarray(t) for t in g]


@pytest.mark.parametrize("streaming", [False, True])
def test_scoring_rule_grad_matches_jax(streaming):
    X, y, want_v, want_g = _jax_scoring_rule()
    tX, ty = _leaves(X, y)
    kw = {"row_block": 1} if streaming else {}
    v = rt.scoring_rule(tX, ty, length_y=5, **kw, **CONFIGS["order2_lam11"][1])
    v.backward()
    close(v.detach(), want_v)
    close(tX.grad, want_g[0])
    close(ty.grad, want_g[1])


def test_streaming_false_wins_over_row_block():
    X, Y = torch.from_numpy(paths(17, 3, 5)), torch.from_numpy(paths(18, 3, 5))
    with dispatch.count_pair_solves() as dense:
        a = rt.mmd2(X, Y, row_block=1, streaming=False)
    with dispatch.count_pair_solves() as streamed:
        b = rt.mmd2(X, Y, row_block=1)
    close(a, b, 1e-13)
    # both solve the same pairs: the two symmetric triangles and the cross
    assert dense.total == streamed.total == 2 * 6 + 9
