"""The port's streaming-reduction guard (``repro_torch.core.gram``:
``StreamingViolation``, ``assert_streaming_reduction``,
``sigkernel_gram_reduce(check_streaming=)``) held to the JAX package's.

* Each JAX guard test (``tests/test_distributed_gram.py``, the densify
  guard; ``tests/test_features.py``, the feature path) has a counterpart
  here at the same shapes, which raises or stays quiet as it does.
* The same numpy inputs go through the JAX guard (``jax.value_and_grad``)
  and the port's (``grad=True``): both raise, naming the same ``(Bx, By)``,
  or both stay quiet.
* The guard is invisible to the results: values and gradients bit for bit
  the unguarded call's, the pair-solve counter unchanged.
* Each Goursat solve is one ``torch.library`` op in the guard's trace (the
  solver's cell loop is not traced), and each op passes
  ``torch.library.opcheck`` (schema, fake implementation) on the CPU.
  ``tests/test_torch_kernels_gpu.py`` (no JAX) does the same for the CUDA
  implementations and holds the guarded reductions on the card bit for bit,
  launches by shape unchanged.
"""

import re
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro
from repro.core import gram as jgram
from repro.core import losses as jlosses
from repro.core.features import FeatureConfig as JFeatureConfig

import repro_torch as rt
from repro_torch.core import dispatch, losses
from repro_torch.kernels.sigkernel_pde import ops

gram = sys.modules["repro_torch.core.gram"]
sk = sys.modules["repro_torch.core.sigkernel"]
ft = sys.modules["repro_torch.core.features"]

F32 = torch.float32


def _paths(seed, B, L, d):
    x = np.random.default_rng(seed).normal(size=(B, L, d)) * 0.1
    return np.cumsum(x, axis=1).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(autouse=True)
def fresh_keys():
    gram._stream_checked.clear()
    yield
    gram._stream_checked.clear()


# ---------------------------------------------------------------------------
# the JAX package's guard tests, ported at their shapes
# ---------------------------------------------------------------------------

def test_guard_fires_on_dense_reduction():
    """The full Gram is caught in the value and the backward."""
    with pytest.raises(gram.StreamingViolation, match=r"\(7, 5\)"):
        gram.assert_streaming_reduction(
            lambda x, y: rt.sigkernel_gram(x, y).sum(), ((7, 9, 2), F32), ((5, 9, 2), F32),
            gram_shape=(7, 5), grad=True)


def test_guard_fires_on_dense_delta_stack():
    """The (Bx, By, Lx, Ly) pairwise Δ stack is caught by the same prefix
    test."""
    with pytest.raises(gram.StreamingViolation, match=r"\(6, 6, 8, 8\)"):
        gram.assert_streaming_reduction(
            lambda x: rt.sigkernel_gram(x, x, symmetric=False).sum(), ((6, 9, 2), F32),
            gram_shape=(6, 6), grad=True)


def test_guard_quiet_on_streaming_reduction():
    gram.assert_streaming_reduction(
        lambda x, y: rt.sigkernel_gram_reduce(x, y, row_block=2), ((7, 9, 2), F32),
        ((5, 9, 2), F32), gram_shape=(7, 5), grad=True)


def test_guard_survives_shape_coincidences():
    """A ragged pad width equal to Bx (L = 9 padded to 16: a (7, 7, 2)
    edge copy at Bx = 7) and the row_block=1 symmetric pair chunk tracking
    Bx are cleared by the bumped re-traces."""
    X = t(_paths(12, 7, 9, 2))
    lens = torch.tensor([4, 9, 6, 7, 8, 5, 9])
    v = losses.mmd2(X, t(_paths(13, 5, 9, 2)), lengths=lens, unbiased=False, row_block=2)
    assert np.isfinite(float(v))
    s = losses.scoring_rule(X, t(_paths(13, 5, 9, 2))[0], row_block=1)
    assert np.isfinite(float(s))


def test_losses_guard_catches_injected_densify(monkeypatch):
    """If the reduction ever densifies, mmd2's streaming raises instead."""
    def densified(sX, sY, kernel, backend, rb, g, launch=None):
        return gram._gram_rows(sX, sY, kernel, backend, g, None).sum()

    monkeypatch.setattr(gram, "_reduce_rows", densified)
    with pytest.raises(gram.StreamingViolation, match=r"\(8, 6\)"):
        losses.mmd2(t(_paths(14, 8, 9, 2)), t(_paths(15, 6, 9, 2)), row_block=2,
                    unbiased=False)


@pytest.mark.parametrize("f", [rt.FeatureConfig("rff", rank=16),
                               rt.FeatureConfig("nystroem", rank=2)], ids=["rff", "nystroem"])
def test_streaming_guard_accepts_feature_path(f):
    Xb = t(_paths(4, 12, 8, 2))      # B > pool (8): even the pool Gram stays below (B, B)
    rt.sigkernel_gram_reduce(Xb, features=f, check_streaming=True)
    q = Xb.clone().requires_grad_()
    g, = torch.autograd.grad(rt.sigkernel_gram_reduce(q, features=f, check_streaming=True), q)
    assert bool(torch.isfinite(g).all())


def test_guard_rejects_dense_feature_free_path():
    with pytest.raises(gram.StreamingViolation):
        gram.assert_streaming_reduction(lambda q: rt.sigkernel_gram(q).sum(),
                                        t(_paths(10, 6, 7, 2)), gram_shape=(6, 6))


def test_nystroem_pool_of_the_whole_batch_passes():
    """Where the Nyström pool takes the whole batch (B = 12 <= 4·rank), its
    landmark Gram is the pool's by the method's design: the bumped traces
    hold the pool at the real call's size and clear it.  The JAX guard lets
    the pool follow the batch and raises."""
    x, y = _paths(5, 12, 8, 2), _paths(6, 11, 8, 2)
    v = rt.mmd2(t(x), t(y), features=rt.FeatureConfig("nystroem", rank=4))
    assert np.isfinite(float(v))
    with pytest.raises(jgram.StreamingViolation, match=r"\(12, 12\)"):
        jlosses.mmd2(jnp.asarray(x), jnp.asarray(y),
                     features=JFeatureConfig("nystroem", rank=4))
    jgram._stream_checked.clear()


# ---------------------------------------------------------------------------
# the port's guard against the JAX guard on the same inputs
# ---------------------------------------------------------------------------

def _verdict(call):
    try:
        call()
    except (gram.StreamingViolation, jgram.StreamingViolation) as e:
        return tuple(map(int, re.search(r"dense \((\d+), (\d+)\)", str(e)).groups()))
    return None


PARITY = {
    "dense_gram": (lambda x, y: repro.sigkernel_gram(x, y).sum(),
                   lambda x, y: rt.sigkernel_gram(x, y).sum(), (7, 5)),
    "dense_delta_stack": (lambda x, y: repro.sigkernel_gram(x, x, symmetric=False).sum(),
                          lambda x, y: rt.sigkernel_gram(x, x, symmetric=False).sum(),
                          (7, 7)),
    "reduce_rows": (lambda x, y: repro.sigkernel_gram_reduce(x, y, row_block=2),
                    lambda x, y: rt.sigkernel_gram_reduce(x, y, row_block=2), (7, 5)),
    "reduce_one_block": (lambda x, y: repro.sigkernel_gram_reduce(x, y, row_block=7),
                         lambda x, y: rt.sigkernel_gram_reduce(x, y, row_block=7), (7, 5)),
    "reduce_symmetric": (lambda x, y: repro.sigkernel_gram_reduce(x, row_block=2),
                         lambda x, y: rt.sigkernel_gram_reduce(x, row_block=2), (7, 7)),
    "rff_features": (
        lambda x, y: repro.sigkernel_gram_reduce(x, y, features=JFeatureConfig("rff", rank=16)),
        lambda x, y: rt.sigkernel_gram_reduce(x, y, features=rt.FeatureConfig("rff", rank=16)),
        (7, 5)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_guard_verdicts_match_jax(case):
    jfn, tfn, shape = PARITY[case]
    x, y = _paths(21, 7, 9, 2), _paths(22, 5, 9, 2)
    want = _verdict(lambda: jgram.assert_streaming_reduction(
        jax.value_and_grad(jfn, argnums=(0, 1)), jnp.asarray(x), jnp.asarray(y),
        gram_shape=shape))
    got = _verdict(lambda: gram.assert_streaming_reduction(tfn, t(x), t(y), gram_shape=shape,
                                                           grad=True))
    assert got == want
    # one block over the whole batch is the dense reduction
    assert (want is not None) == (case.startswith("dense") or case == "reduce_one_block")


@pytest.mark.parametrize("densify", [False, True])
def test_mmd2_guard_verdicts_match_jax(monkeypatch, densify):
    x, y = _paths(14, 8, 9, 2), _paths(15, 6, 9, 2)
    if densify:
        monkeypatch.setattr(jgram, "_reduce_rows", lambda sX, sY, kernel, backend, rb, g,
                            launch=None: jgram._gram_rows(sX, sY, kernel, backend, g,
                                                          None).sum())
        monkeypatch.setattr(gram, "_reduce_rows", lambda sX, sY, kernel, backend, rb, g,
                            launch=None: gram._gram_rows(sX, sY, kernel, backend, g,
                                                         None).sum())
    jgram._stream_checked.clear()
    try:
        want = _verdict(lambda: jlosses.mmd2(jnp.asarray(x), jnp.asarray(y), row_block=2,
                                             unbiased=False))
    finally:
        jgram._stream_checked.clear()
    got = _verdict(lambda: losses.mmd2(t(x), t(y), row_block=2, unbiased=False))
    assert got == want == ((8, 6) if densify else None)


# ---------------------------------------------------------------------------
# the guard is invisible to the results
# ---------------------------------------------------------------------------

CASES = {
    "antidiag": dict(backend="antidiag"),
    "reference": dict(backend="reference"),
    "rbf_ragged": dict(static_kernel=rt.RBF(0.7), ragged=True),
    "refined_order2": dict(grid=rt.GridConfig(1, 1, scheme="order2")),
}


def _run(guarded, kw, monkeypatch):
    """mmd2 and scoring_rule, streaming, and their gradients, with the
    pair-solve count; ``guarded=False`` takes the guard out."""
    kw = dict(kw)
    ragged = kw.pop("ragged", False)
    X, Y = t(_paths(31, 7, 8, 3)), t(_paths(32, 5, 8, 3))
    lx = torch.tensor([8, 4, 7, 2, 8, 3, 6]) if ragged else None
    ly = torch.tensor([6, 8, 3, 2, 8]) if ragged else None
    with monkeypatch.context() as m:
        if not guarded:
            m.setattr(gram, "_guard_reduce", lambda *a, **k: None)
        a, b = X.clone().requires_grad_(), Y.clone().requires_grad_()
        with dispatch.count_pair_solves() as c:
            v = losses.mmd2(a, b, row_block=2, lengths=lx, lengths_y=ly, **kw)
            s = losses.scoring_rule(a, b[0], row_block=3, lengths=lx, **kw)
            grads = torch.autograd.grad(v + s, (a, b))
    return (v, s, *grads), c.total


@pytest.mark.parametrize("case", sorted(CASES))
def test_guard_leaves_values_gradients_and_counts(case, monkeypatch):
    got, n_got = _run(True, CASES[case], monkeypatch)
    assert len(gram._stream_checked) == 5      # three mmd2 terms, two scoring-rule terms
    want, n_want = _run(False, CASES[case], monkeypatch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert n_got == n_want > 0


def test_guard_runs_once_per_key(monkeypatch):
    X, Y = t(_paths(33, 6, 8, 2)), t(_paths(34, 4, 8, 2))
    calls = []
    real = gram._dense_intermediates
    monkeypatch.setattr(gram, "_dense_intermediates",
                        lambda *a, **k: calls.append(k["gram_shape"]) or real(*a, **k))
    first = losses.mmd2(X, Y, row_block=1)
    assert sorted(calls) == [(4, 4), (6, 4), (6, 6)]
    assert torch.equal(losses.mmd2(X, Y, row_block=1), first)
    assert len(calls) == 3
    losses.mmd2(X, Y, row_block=2)          # another row block: another key
    assert len(calls) == 6
    losses.mmd2(X, Y)                       # not streaming: no guard
    assert len(calls) == 6


# ---------------------------------------------------------------------------
# each Goursat solve is one op in the trace
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _trace_ops(fn, *specs):
    """``({solve op: calls}, all ops)`` of fn(*fake leaves) and its
    backward, traced as the guard traces them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rec = _Ops()
    with FakeTensorMode():
        leaves = [torch.empty(shape, dtype=dtype).requires_grad_() for shape, dtype in specs]
        with rec:
            torch.autograd.grad(fn(*leaves), leaves)
    solves = {k.split(".")[-1]: n for k, n in rec.ops.items() if k.startswith("repro_torch.")}
    return solves, sum(rec.ops.values())


@pytest.mark.parametrize("backend, want", [
    ("reference", {"goursat_rows": 1, "goursat_rows_grad": 1}),
    ("antidiag", {"goursat_antidiag": 1, "goursat_antidiag_grad": 1}),
])
def test_each_solve_is_one_op_in_the_trace(backend, want):
    """The trace's ops do not grow with the grid (the cell loop would issue
    thousands at L = 33)."""
    traced = [_trace_ops(lambda x, y: rt.sigkernel_gram(x, y, backend=backend).sum(),
                         ((3, L, 2), F32), ((2, L, 2), F32)) for L in (9, 33)]
    assert traced[0] == traced[1]
    assert traced[0][0] == want


@pytest.mark.parametrize("what, want", [
    ("solve", {"goursat_fwd_cps": 1, "goursat_bwd": 1}),
    ("solve_fused", {"goursat_fwd_fused": 1, "goursat_fwd_cps": 1, "goursat_bwd": 1}),
    ("gram_fused", {"goursat_gram_fused": 1, "goursat_fwd_cps": 1, "goursat_bwd": 1}),
])
def test_each_kernel_solve_is_one_op_in_the_trace(what, want):
    """The CUDA kernels' ops, through their wrappers on CPU tensors (the
    plain versions); the public entry points reach them on the card
    (``test_guarded_reduction_on_the_card_is_bit_for_bit``)."""
    traced = []
    for L in (8, 32):
        if what == "solve":
            fn, specs = (lambda d: ops.solve(d).sum()), (((3, L, L), F32),)
        else:
            fn = lambda a, b: getattr(ops, what)(a, b).sum()    # noqa: E731
            specs = (((3, L, 2), F32), ((3 if what == "solve_fused" else 2, L, 2), F32))
        traced.append(_trace_ops(fn, *specs))
    assert traced[0] == traced[1]
    assert traced[0][0] == want


def test_forward_without_grad_is_one_op():
    rec = _Ops()
    delta = torch.rand(2, 5, 6) * 0.1
    with rec:
        ops.solve(delta)
        sk.solve_goursat(delta)
        sk.solve_goursat_antidiag(delta)
    assert {k: n for k, n in rec.ops.items() if k.startswith("repro_torch.")} == {
        "repro_torch.goursat_fwd": 1, "repro_torch.goursat_rows": 1,
        "repro_torch.goursat_antidiag": 1}


def test_rff_feature_path_is_one_op_a_map():
    """The RFF scan is one op a feature map (the dense mmd2 maps X twice and
    Y twice) and its backward gives the gradient's shape alone, whatever the
    path length: the guard's trace of an RFF mmd2 stays small."""
    f = rt.FeatureConfig("rff", rank=4)
    traced = [_trace_ops(lambda x, y: rt.mmd2(x, y, features=f, streaming=False),
                         ((4, L, 2), F32), ((3, L, 2), F32)) for L in (9, 65)]
    assert traced[0] == traced[1]
    assert traced[0][0] == {"rff_scan": 4}


def test_rff_scan_gradient_is_autograds_through_the_steps():
    g = torch.Generator().manual_seed(4)
    inc = torch.randn(5, 17, 6, generator=g, dtype=torch.float64) * 0.3
    proj = torch.randn(7, 4, 6, generator=g, dtype=torch.float64)
    a, b = inc.clone().requires_grad_(), inc.clone().requires_grad_()
    op_out, steps_out = ft._sig_projection_scan(a, proj), ft._projection_scan(b, proj)
    cot = torch.randn(op_out.shape, generator=g, dtype=torch.float64)
    assert torch.equal(op_out, steps_out)
    assert torch.equal(torch.autograd.grad(op_out, a, cot)[0],
                       torch.autograd.grad(steps_out, b, cot)[0])


# ---------------------------------------------------------------------------
# opcheck: schema and fake implementation of every op
# ---------------------------------------------------------------------------

OPCHECK = ("test_schema", "test_faketensor")


def _op_args(name):
    """The op and float64 CPU arguments of one small call (the plain
    versions take no geometry or strip height on the CPU: 0)."""
    g = torch.Generator().manual_seed(3)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, generator=g, dtype=torch.float64) * scale

    delta, dx, dy, d4 = r(3, 20, 17), r(3, 20, 4, scale=0.3), r(3, 17, 4, scale=0.3), r(2, 3, 9, 7)
    s2 = (1, 0, "order2", "float32")
    if name == "goursat_fwd":
        return ops.goursat_fwd, (delta, 0, 0, *s2)
    if name == "goursat_fwd_cps":
        return ops.goursat_fwd_cps, (delta, 8, 0, 0, *s2)
    if name == "goursat_bwd":
        _, cps = ops.goursat_fwd_cps(delta, 8, 0, 0, *s2)
        return ops.goursat_bwd, (delta, cps, r(3, scale=1.0), 8, *s2)
    if name == "goursat_fwd_fused":
        return ops.goursat_fwd_fused, (dx, dy, 0, 0, 0, "order1", "bfloat16")
    if name == "goursat_gram_fused":
        return ops.goursat_gram_fused, (dx, dy[:2], 0, 0, 0, "order1", "float32")
    if name == "goursat_rows":
        return sk.goursat_rows, (d4, 1, 1, True, "order2", "bfloat16")
    if name == "goursat_antidiag":
        return sk.goursat_antidiag, (d4, 0, 1, 2, "order1", "float32")
    if name == "goursat_rows_grad":
        grid = sk.goursat_rows(d4, 1, 1, True, "order1", "float32")
        return sk.goursat_rows_grad, (d4, grid, r(2, 3, scale=1.0), 1, 1, "order1", "float32")
    if name == "goursat_antidiag_grad":
        return sk.goursat_antidiag_grad, (d4, r(2, 3, scale=1.0), 1, 0, "order2", "float32")
    return ft.rff_scan, (r(3, 11, 5, scale=0.3), r(6, 4, 5, scale=1.0))


ALL_OPS = ["goursat_antidiag", "goursat_antidiag_grad", "goursat_bwd", "goursat_fwd",
           "goursat_fwd_cps", "goursat_fwd_fused", "goursat_gram_fused", "goursat_rows",
           "goursat_rows_grad", "rff_scan"]


@pytest.mark.parametrize("name", ALL_OPS)
def test_every_solve_is_a_registered_op(name):
    op, _ = _op_args(name)
    assert getattr(torch.ops.repro_torch, name).default is op


@pytest.mark.parametrize("name", ALL_OPS)
def test_opcheck_cpu(name):
    op, args = _op_args(name)
    assert set(torch.library.opcheck(op, args, test_utils=OPCHECK).values()) == {"SUCCESS"}
