"""The port's spans (``repro_torch.spans``) and its count of blocking
transfers (``dispatch.count_host_syncs``), on the CPU.

* Under a CPU ``torch.profiler``, ``mmd2`` and ``sigkernel`` on the plain
  backends open the entry, front-end, prepare, Δ and sync spans, nested as
  named; the fused routes' backwards (their plain versions on CPU tensors)
  open the Δ and pullback spans, and no Goursat op lies under either.
* With the profiler off, a span enters no ``record_function``.
* ``count_host_syncs`` counts 4 uploads a symmetric Gram, 4 a sharded cross
  Gram, none in ``sigkernel``: 8 a call of ``mmd2`` and 12 of the sharded
  MMD² on a gloo group of one rank.
* The streaming guard and the dry run give the same verdicts and counts
  with a CPU profiler running as without.
"""

from collections import Counter

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

import repro_torch as rt
from repro_torch import spans
from repro_torch.core import dispatch, gram
from repro_torch.kernels.sigkernel_pde import ops as pde_ops
from repro_torch.launch import spawn_ranks

import torch_sharded_ranks as ranks

CPU = [torch.profiler.ProfilerActivity.CPU]


def _paths(seed, B, L, d, drift=0.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, L, d, generator=g) * 0.1).cumsum(1) + drift


def _profiled(fn):
    """``fn()``'s events under a CPU profiler: (name, names of its
    enclosing events, innermost first)."""
    with torch.profiler.profile(activities=CPU) as prof:
        fn()
    out = []
    for e in prof.events():
        up, p = [], e.cpu_parent
        while p is not None:
            up.append(p.name)
            p = p.cpu_parent
        out.append((e.name, tuple(up)))
    return out


def _spans(events):
    return Counter(n for n, _ in events if n in spans.NAMES)


def _within(events, name, outer):
    """Every ``name`` event lies inside an ``outer`` one."""
    found = [up for n, up in events if n == name]
    return bool(found) and all(outer in up for up in found)


def _mmd2_call():
    X = _paths(1, 4, 9, 2).requires_grad_()
    Y = _paths(2, 5, 8, 2, drift=0.3)
    v = rt.mmd2(X, Y)
    torch.autograd.grad(v, X)


def _sigkernel_call():
    x = _paths(3, 3, 9, 2).requires_grad_()
    y = _paths(4, 3, 7, 2)
    torch.autograd.grad(rt.sigkernel(x, y).sum(), x)


def test_mmd2_opens_its_spans_nested_as_named():
    ev = _profiled(_mmd2_call)
    got = _spans(ev)
    # three Grams: Kxx, Kyy symmetric (2 + 2 uploads each), Kxy from 2 streams
    assert got[spans.ENTRY_MMD2] == 1 and got[spans.ENTRY_GRAM] == 3
    assert got[spans.FRONT_END] == 3 and got[spans.PREPARE] == 4 and got[spans.SYNC] == 8
    assert got[spans.DELTA] >= 3
    assert _within(ev, spans.ENTRY_GRAM, spans.ENTRY_MMD2)
    for inner in (spans.FRONT_END, spans.PREPARE, spans.SYNC, spans.DELTA):
        assert _within(ev, inner, spans.ENTRY_GRAM), inner


def test_sigkernel_opens_its_spans_nested_as_named():
    ev = _profiled(_sigkernel_call)
    got = _spans(ev)
    assert got[spans.ENTRY_SIGKERNEL] == 1 and got[spans.FRONT_END] == 1
    assert got[spans.PREPARE] == 1 and got[spans.DELTA] == 1 and got[spans.SYNC] == 0
    for inner in (spans.FRONT_END, spans.PREPARE, spans.DELTA):
        assert _within(ev, inner, spans.ENTRY_SIGKERNEL), inner
    # Δ and its increments are disjoint steps
    assert not any(spans.PREPARE in up for n, up in ev if n == spans.DELTA)


@pytest.mark.parametrize("route", ["solve_fused", "gram_fused"])
def test_fused_backwards_open_delta_and_pullback(route):
    dx = _paths(5, 3, 8, 2).diff(dim=1).requires_grad_()
    dy = _paths(6, 3, 7, 2).diff(dim=1).requires_grad_()

    def call():
        k = getattr(pde_ops, route)(dx, dy)
        torch.autograd.grad(k.sum(), (dx, dy))

    ev = _profiled(call)
    got = _spans(ev)
    # the rebuilt Δ, then its layout for the checkpoint forward and the backward
    assert got[spans.DELTA] == 3 and got[spans.PULLBACK] == 1
    goursat = [(n, up) for n, up in ev if n.startswith("repro_torch::goursat_")]
    assert {n for n, _ in goursat} >= {"repro_torch::goursat_fwd_cps",
                                       "repro_torch::goursat_bwd"}
    assert not any(spans.DELTA in up or spans.PULLBACK in up for _, up in goursat)
    # the rebuilt Δ's product and the pullback's products lie under their spans
    assert any(spans.DELTA in up for n, up in ev if n == "aten::einsum")
    assert any(spans.PULLBACK in up for n, up in ev
               if n in ("aten::einsum", "aten::matmul"))


def test_span_off_enters_no_record_function(monkeypatch):
    entered = []
    real = autograd_profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(autograd_profiler.record_function, "__enter__", counting)
    assert spans.span(spans.DELTA) is spans.span(spans.SYNC)
    _mmd2_call()
    _sigkernel_call()
    assert entered == []
    _profiled(_sigkernel_call)
    assert spans.ENTRY_SIGKERNEL in entered


def test_span_names_are_the_ports():
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    assert all(n.startswith("repro_torch.") and "::" not in n for n in spans.NAMES)


@pytest.mark.parametrize("call, want", [
    (lambda: rt.mmd2(_paths(1, 4, 9, 2), _paths(2, 5, 8, 2)), 8),
    (lambda: _mmd2_call(), 8),
    (lambda: rt.sigkernel_gram(_paths(1, 4, 9, 2)), 4),
    (lambda: rt.sigkernel_gram(_paths(1, 4, 9, 2), _paths(2, 3, 9, 2)), 0),
    (lambda: rt.sigkernel_gram_reduce(_paths(1, 4, 9, 2), row_block=1), 3),
    (lambda: _sigkernel_call(), 0),
], ids=["mmd2", "mmd2_grad", "gram_sym", "gram_cross", "reduce_sym", "sigkernel"])
def test_count_host_syncs(call, want):
    with dispatch.count_host_syncs() as c:
        call()
    assert c.total == want


def test_count_host_syncs_sharded_mmd2():
    """Three sharded Grams on a gloo group of one rank: 4 uploads each
    symmetric Gram, 4 in the cross Gram's two deals, with the collectives'
    spans in the forward and the backward."""
    out, = spawn_ranks(ranks.sync_count_rank, 1, backend="gloo")
    assert out["syncs"] == 12
    assert out["spans"][spans.ENTRY_GRAM_SHARDED] == 3 and out["spans"][spans.SYNC] == 12
    assert out["spans"][spans.COLLECTIVE] > 0


@pytest.fixture
def fresh_keys():
    gram._stream_checked.clear()
    yield
    gram._stream_checked.clear()


def _guard_verdicts():
    """Verdicts of a streaming and a dense reduction, and the counts of the
    guarded streaming ``mmd2``."""
    F32 = torch.float32
    quiet = gram.assert_streaming_reduction(
        lambda x, y: rt.sigkernel_gram_reduce(x, y, row_block=2), ((7, 9, 2), F32),
        ((5, 9, 2), F32), gram_shape=(7, 5), grad=True)
    try:
        gram.assert_streaming_reduction(
            lambda x, y: rt.sigkernel_gram(x, y).sum(), ((7, 9, 2), F32), ((5, 9, 2), F32),
            gram_shape=(7, 5), grad=True)
        dense = None
    except gram.StreamingViolation as exc:
        dense = str(exc)
    gram._stream_checked.clear()
    with dispatch.count_host_syncs() as s, dispatch.count_pair_solves() as p:
        v = rt.mmd2(_paths(1, 7, 9, 2), _paths(2, 5, 9, 2), row_block=2)
    return quiet, dense, s.total, p.total, float(v)


def test_guard_alike_with_the_profiler_running(fresh_keys):
    plain = _guard_verdicts()
    gram._stream_checked.clear()
    with torch.profiler.profile(activities=CPU):
        profiled = _guard_verdicts()
    assert plain == profiled
    assert plain[0] is None and plain[1] is not None and "(7, 5)" in plain[1]


def _dry_run():
    from repro_torch.models import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapePreset
    rec = dryrun.run_cell(get_config("sigkernel-workload"),
                          ShapePreset("sig_small", "sig_fwd", 16, 8), (2, 2),
                          ("data", "model"))
    return {k: rec[k] for k in ("flops", "hlo_dot_flops", "argument_bytes", "output_bytes",
                                "collectives")}


def test_dry_run_alike_with_the_profiler_running():
    plain = _dry_run()
    with torch.profiler.profile(activities=CPU):
        profiled = _dry_run()
    assert plain == profiled
    assert plain["flops"] == 4 * 4 * 2 * (16 - 1) ** 2 * 8
