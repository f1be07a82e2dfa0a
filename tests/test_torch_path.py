"""The port's streaming ``Path`` against the JAX package's.

The same numpy points go through ``repro.stream.Path`` and
``repro_torch.stream.Path`` on the CPU.  Float64 cases run inside
``jax.enable_x64(True)`` and hold to 1e-10 relative, since both packages do
the same group arithmetic.  Prefix queries ``signature(0, j)`` must equal
the port's own plain scan ``signature(points[:j], backend="reference")``
bit for bit, in float32 and float64.

The op counters differ by design: the JAX package counts at trace time (a
warm jit cache records nothing), the port counts every call.  The counter
tests therefore hold the port to the contract (a query is one combine and
no scan step; an update scans its chunk bucket, never the history), never
to JAX's counter values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.stream import Path as JPath
from repro.stream import coalesced_update as jcoalesced
from repro_torch.core import dispatch
from repro_torch.core import tensoralg as ta
from repro_torch.kernels.signature import kernel as sig_kernel
from repro_torch.stream import (Path, RollingConfig, coalesced_update,
                                reset_trace_counts, trace_counts)

PIPES = {
    "plain": (rt.TransformPipeline(), repro.TransformPipeline()),
    "lead_lag": (rt.TransformPipeline(lead_lag=True),
                 repro.TransformPipeline(lead_lag=True)),
}


def pts(seed, L, d, scale=0.3, dtype=np.float64):
    return (np.random.default_rng(seed).normal(size=(L, d)) * scale).astype(dtype)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


# ---------------------------------------------------------------------------
# prefix and interval queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("pipe", PIPES, ids=PIPES.keys())
def test_prefix_queries_bitwise_vs_reference(pipe, dtype):
    tp = PIPES[pipe][0]
    x = t(pts(0, 13, 3, dtype=dtype))
    p = Path.from_points(x, depth=3, transforms=tp)
    for j in (2, 5, 11, 13):
        assert torch.equal(p.signature(0, j),
                           rt.signature(x[:j], 3, transforms=tp, backend="reference")), j
    assert torch.equal(p.signature(), rt.signature(x, 3, transforms=tp, backend="reference"))


@pytest.mark.parametrize("pipe", PIPES, ids=PIPES.keys())
def test_prefix_queries_vs_jax(pipe):
    tp, jtp = PIPES[pipe]
    x = pts(0, 13, 3)
    p = Path.from_points(t(x), depth=3, transforms=tp)
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=3, transforms=jtp)
        for j in (2, 5, 13):
            close(p.signature(0, j), jp.signature(0, j), 1e-10)


def test_prefix_queries_vs_horner_plain():
    # the Horner kernel's plain version folds in its own order: f32 values gate
    x = t(pts(1, 10, 3, dtype=np.float32))
    p = Path.from_points(x, depth=3)
    for j in (4, 10):
        z = (x[1:j] - x[:j - 1])[None]
        close(p.signature(0, j), sig_kernel.horner_plain(z, 3)[0], 5e-5)


@pytest.mark.parametrize("pipe", PIPES, ids=PIPES.keys())
@pytest.mark.parametrize("i,j", [(1, 3), (3, 8), (5, 13), (11, 13)])
def test_interval_queries_vs_jax(pipe, i, j):
    tp, jtp = PIPES[pipe]
    x = pts(2, 13, 3)
    p = Path.from_points(t(x), depth=3, transforms=tp)
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=3, transforms=jtp)
        close(p.signature(i, j), jp.signature(i, j), 1e-10)
    close(p.signature(i, j), rt.signature(t(x[i:j]), 3, transforms=tp), 1e-10)


def test_interval_queries_chen_consistent():
    x = t(pts(3, 16, 2))
    p = Path.from_points(x, depth=4)
    a, b, ab = p.signature(2, 8), p.signature(7, 14), p.signature(2, 14)
    close(ta.chen(a, b, 2, 4), ab, 1e-12)


@pytest.mark.parametrize("mode", ["lyndon", "brackets", "expand"])
def test_logsignature_intervals_vs_jax(mode):
    x = pts(4, 12, 3)
    p = Path.from_points(t(x), depth=3)
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=3)
        close(p.logsignature(3, 9, mode=mode), jp.logsignature(3, 9, mode=mode), 1e-10)
        close(p.logsignature(0, 7, mode=mode), jp.logsignature(0, 7, mode=mode), 1e-10)
    close(p.logsignature(0, 7, mode=mode),
          rt.logsignature(t(x[:7]), 3, mode=mode, backend="reference"), 1e-12)


# ---------------------------------------------------------------------------
# O(1) queries: no scan step, one combine, on every call
# ---------------------------------------------------------------------------

def test_interval_query_is_one_combine_no_scan():
    x = t(pts(5, 40, 4))
    p = Path.from_points(x, depth=2)
    for _ in range(2):                     # the port counts every call
        with dispatch.count_scan_steps() as sc, dispatch.count_combines() as cc:
            q = p.signature(3, 37)
        assert sc.total == 0, "interval query re-scanned the path"
        assert cc.total == 1, cc.total
    close(q, rt.signature(x[3:37], 2), 1e-10)


def test_prefix_query_is_a_read():
    p = Path.from_points(t(pts(5, 20, 2)), depth=2)
    with dispatch.count_scan_steps() as sc, dispatch.count_combines() as cc:
        p.signature(0, 17)
    assert sc.total == 0 and cc.total == 0


# ---------------------------------------------------------------------------
# update(): O(chunk) scans, agreement with JAX and with a recompute
# ---------------------------------------------------------------------------

def test_update_agrees_with_jax():
    x, more = pts(6, 11, 3), pts(7, 6, 3)
    p = Path.from_points(t(x), depth=3).update(t(more))
    assert len(p) == 17
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=3).update(jnp.asarray(more))
        close(p.signature(), jp.signature(), 1e-10)
        close(p.signature(8, 15), jp.signature(8, 15), 1e-10)
    full = t(np.concatenate([x, more]))
    close(p.signature(), rt.signature(full, 3), 1e-12)


def test_update_scans_only_the_chunk():
    x, chunk = t(pts(8, 50, 5)), t(pts(9, 3, 5))
    with dispatch.count_scan_steps() as sc_build:
        p = Path.from_points(x, depth=2)
    assert sc_build.total == p.capacity - 1, "build scans the buffer once"
    with dispatch.count_scan_steps() as sc:
        p2 = p.update(chunk)
    assert sc.total == 4, f"update scanned {sc.total} steps for a 3-point chunk (bucket 4)"
    close(p2.signature(), rt.signature(torch.cat([x, chunk]), 2), 1e-12)


def test_update_counts_every_call():
    x = t(pts(10, 20, 6))
    p = Path.from_points(x, depth=2)
    before = trace_counts()
    ticks = [t(pts(s, 1, 6)) for s in range(11, 18)]
    with dispatch.count_scan_steps() as sc:
        for tick in ticks:
            p = p.update(tick)
    assert trace_counts()["update"] - before["update"] == len(ticks)
    assert sc.total == len(ticks)          # one step a one-point chunk
    close(p.signature(), rt.signature(torch.cat([x] + ticks), 2), 1e-12)


def test_build_buckets_capacity():
    before = trace_counts()
    p1 = Path.from_points(t(pts(20, 9, 7)), depth=2)
    p2 = Path.from_points(t(pts(21, 15, 7)), depth=2)
    assert p1.capacity == p2.capacity == 16
    assert trace_counts()["build"] - before["build"] == 2


def test_update_grows_capacity():
    x, more = pts(22, 14, 2), pts(23, 9, 2)
    p = Path.from_points(t(x), depth=3)
    assert p.capacity == 16
    p2 = p.update(t(more))
    assert p2.capacity == 32 and len(p2) == 23
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=3).update(jnp.asarray(more))
        close(p2.signature(), jp.signature(), 1e-10)
        close(p2.signature(10, 20), jp.signature(10, 20), 1e-10)


def test_update_lead_lag():
    tp, jtp = PIPES["lead_lag"]
    x, more = pts(24, 9, 2), pts(25, 4, 2)
    p = Path.from_points(t(x), depth=2, transforms=tp).update(t(more))
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=2, transforms=jtp).update(
            jnp.asarray(more))
        close(p.signature(), jp.signature(), 1e-10)
    close(p.signature(), rt.signature(t(np.concatenate([x, more])), 2, transforms=tp),
          1e-12)


def test_batched_path_matches_single_paths():
    """A (B, L, d) batch of paths sharing a length: build, update, evict and
    queries equal the same calls on each path alone.  (The JAX package's
    update takes unbatched paths only: its gather of the tip fails on a
    batch.)"""
    xs, more = pts(33, 3 * 14, 2).reshape(3, 14, 2), pts(34, 3 * 5, 2).reshape(3, 5, 2)
    batch = Path.from_points(t(xs), depth=3, retention=16).update(t(more))
    for b in range(3):
        one = Path.from_points(t(xs[b]), depth=3, retention=16).update(t(more[b]))
        assert len(one) == len(batch) == 16
        for i, j in [(0, None), (2, 11), (0, 9)]:
            close(batch.signature(i, j)[b], one.signature(i, j), 1e-12)
        close(batch.rolling(5, stride=2)[b], one.rolling(5, stride=2), 1e-12)


def test_path_is_immutable():
    x = t(pts(29, 9, 2))
    p = Path.from_points(x, depth=3)
    sig = p.signature().clone()
    p2 = p.update(t(pts(30, 2, 2)))
    assert p2 is not p and len(p) == 9 and len(p2) == 11
    assert torch.equal(p.signature(), sig)
    assert p.evict(before=3) is not p and torch.equal(p.signature(), sig)


# ---------------------------------------------------------------------------
# rolling windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,stride", [(2, 1), (5, 1), (4, 3), (13, 5)])
def test_rolling_vs_jax(window, stride):
    x = pts(26, 17, 3)
    p = Path.from_points(t(x), depth=3)
    out = p.rolling(window, stride=stride)
    assert out.shape == (RollingConfig(window, stride).num_windows(17), p.sig_dim)
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=3)
        close(out, jp.rolling(window, stride=stride), 1e-10)
    for w in range(out.shape[0]):
        close(out[w], rt.signature(t(x[w * stride:w * stride + window]), 3), 1e-10)


def test_rolling_config_and_validation():
    p = Path.from_points(t(pts(27, 10, 2)), depth=2)
    assert torch.equal(p.rolling(RollingConfig(window=4, stride=2)), p.rolling(4, stride=2))
    with pytest.raises(ValueError, match="window"):
        RollingConfig(window=1)
    with pytest.raises(ValueError, match="stride"):
        RollingConfig(window=3, stride=0)
    with pytest.raises(ValueError, match="window fits"):
        p.rolling(11)


def test_rolling_is_combines_not_scans():
    p = Path.from_points(t(pts(28, 33, 3)), depth=5)
    with dispatch.count_scan_steps() as sc, dispatch.count_combines() as cc:
        out = p.rolling(8, stride=4)
    assert sc.total == 0, "rolling re-scanned the path"
    assert out.shape[0] == 7
    assert cc.total == 7, cc.total       # one combine a window, no padding


# ---------------------------------------------------------------------------
# gradients (torch.autograd against jax.grad)
# ---------------------------------------------------------------------------

def test_gradients_flow_through_stored_prefixes():
    x = pts(30, 10, 2)
    leaf = t(x).requires_grad_()
    (g,) = torch.autograd.grad((Path.from_points(leaf, depth=3).signature(2, 8) ** 2).sum(),
                               leaf)
    with jax.enable_x64(True):
        g_jax = jax.grad(lambda q: jnp.sum(
            JPath.from_points(q, depth=3).signature(2, 8) ** 2))(jnp.asarray(x))
        close(g, g_jax, 1e-10)
    assert float(g[9].abs().max()) == 0.0   # outside [2, 8): no gradient


def test_gradients_through_update():
    base, chunk = pts(31, 8, 2), pts(32, 3, 2)
    leaf = t(chunk).requires_grad_()
    (g,) = torch.autograd.grad(
        (Path.from_points(t(base), depth=2).update(leaf).signature() ** 2).sum(), leaf)
    with jax.enable_x64(True):
        g_jax = jax.grad(lambda c: jnp.sum(
            JPath.from_points(jnp.asarray(base), depth=2).update(c).signature() ** 2))(
            jnp.asarray(chunk))
        close(g, g_jax, 1e-10)


def test_gradients_flow_through_evict():
    x = pts(97, 12, 2)
    leaf = t(x).requires_grad_()
    (g,) = torch.autograd.grad(Path.from_points(leaf, depth=2).evict(before=4)
                               .signature().sum(), leaf)
    with jax.enable_x64(True):
        g_jax = jax.grad(lambda q: JPath.from_points(q, depth=2).evict(before=4)
                         .signature().sum())(jnp.asarray(x))
        close(g, g_jax, 1e-10)
    # evicted points cancel through the inverse splice
    assert float(g[:3].abs().max()) <= 1e-12
    assert float(g[5:].abs().max()) > 0


# ---------------------------------------------------------------------------
# coalesced updates (the serving hot path)
# ---------------------------------------------------------------------------

def test_coalesced_update_matches_jax_and_solo():
    chunks = [pts(40, 1, 3), pts(41, 3, 3), pts(42, 2, 3)]
    xs = [pts(43 + i, 9 + i, 3) for i in range(3)]
    got = coalesced_update([Path.from_points(t(x), depth=3) for x in xs],
                           [t(c) for c in chunks])
    with jax.enable_x64(True):
        want = jcoalesced([JPath.from_points(jnp.asarray(x), depth=3) for x in xs],
                          [jnp.asarray(c) for c in chunks])
        for out, jout in zip(got, want):
            assert len(out) == int(jout.length)
            close(out.signature(), jout.signature(), 1e-10)
    for x, c, out in zip(xs, chunks, got):
        solo = Path.from_points(t(x), depth=3).update(t(c))
        close(out.signature(), solo.signature(), 1e-12)


def test_coalesced_update_is_one_batched_call():
    paths = [Path.from_points(t(pts(50 + i, 10, 2)), depth=5) for i in range(3)]
    chunks = [t(pts(60 + i, 1, 2)) for i in range(3)]
    before = trace_counts()
    with dispatch.count_scan_steps() as sc:
        coalesced_update(paths, chunks)
    assert trace_counts()["update"] - before["update"] == 1
    assert sc.total == 1, sc.total       # one batched scan of the chunk bucket


def test_coalesced_update_validates_groups():
    p16 = Path.from_points(t(pts(70, 9, 2)), depth=2)
    p32 = Path.from_points(t(pts(71, 20, 2)), depth=2)
    with pytest.raises(ValueError, match="homogeneous"):
        coalesced_update([p16, p32], [t(pts(72, 1, 2)), t(pts(73, 1, 2))])
    with pytest.raises(ValueError, match="chunks"):
        coalesced_update([p16], [])
    with pytest.raises(ValueError, match="capacity"):
        coalesced_update([p16], [t(pts(74, 8, 2))])


def test_coalesced_update_honours_retention():
    xs = [pts(96 + i, 12, 2) for i in range(3)]
    chunks = [pts(99 + i, 4, 2) for i in range(3)]
    got = coalesced_update([Path.from_points(t(x), depth=2, retention=14) for x in xs],
                           [t(c) for c in chunks])
    with jax.enable_x64(True):
        want = jcoalesced([JPath.from_points(jnp.asarray(x), depth=2, retention=14)
                           for x in xs], [jnp.asarray(c) for c in chunks])
        for out, jout in zip(got, want):
            close(out.signature(), jout.signature(), 1e-10)
    for p, x, c in zip(got, xs, chunks):
        assert len(p) == 14
        close(p.signature(), rt.signature(t(np.concatenate([x, c])[-14:]), 2), 1e-10)


# ---------------------------------------------------------------------------
# validation and transform restrictions
# ---------------------------------------------------------------------------

def test_transform_restrictions():
    x = t(pts(80, 8, 2))
    for tp in (rt.TransformPipeline(time_aug=True), rt.TransformPipeline(basepoint=True)):
        with pytest.raises(ValueError, match="lead_lag only"):
            Path.from_points(x, depth=2, transforms=tp)
    Path.from_points(x, depth=2, transforms=rt.TransformPipeline(lead_lag=True))


def test_interval_validation():
    p = Path.from_points(t(pts(81, 8, 2)), depth=2)
    for bad in [(-1, 5), (3, 4), (5, 5), (0, 9)]:
        with pytest.raises(ValueError, match="interval"):
            p.signature(*bad)
    with pytest.raises(ValueError, match="at least 2 points"):
        Path.from_points(t(pts(82, 1, 2)), depth=2)
    with pytest.raises(ValueError, match="at least one new point"):
        p.update(torch.zeros((0, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="new points"):
        p.update(torch.zeros((3, 5), dtype=torch.float64))


# ---------------------------------------------------------------------------
# eviction and retention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipe", PIPES, ids=PIPES.keys())
def test_evict_matches_jax_and_fresh_build(pipe):
    tp, jtp = PIPES[pipe]
    x = pts(90, 21, 3)
    p = Path.from_points(t(x), depth=3, transforms=tp).evict(before=7)
    fresh = Path.from_points(t(x[7:]), depth=3, transforms=tp)
    assert len(p) == len(fresh) == 14 and p.capacity == fresh.capacity
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=3, transforms=jtp).evict(before=7)
        for i, j in [(0, None), (0, 5), (2, 9), (4, 14)]:
            close(p.signature(i, j), jp.signature(i, j), 1e-10)
            close(p.signature(i, j), fresh.signature(i, j), 1e-10)


def test_evict_is_combines_not_scans():
    x = t(pts(91, 19, 4))
    p = Path.from_points(x, depth=3)
    with dispatch.count_scan_steps() as scans, dispatch.count_combines() as combines:
        pe = p.evict(before=5)
    assert scans.total == 0
    assert combines.total == pe.capacity - 1     # one batched combine, M = C - 1 rows
    close(pe.signature(), rt.signature(x[5:], 3), 1e-10)


def test_evict_validation():
    p = Path.from_points(t(pts(92, 10, 2)), depth=2)
    assert p.evict(before=0) is p
    for bad in (-1, 1.5, True):
        with pytest.raises(ValueError, match="evict"):
            p.evict(before=bad)
    with pytest.raises(ValueError, match="at least one increment"):
        p.evict(before=9)
    p.evict(before=8)


def test_retention_caps_memory_with_zero_rescans():
    """The JAX test of the same name counts at trace time; the port counts
    every call, so 12 updates of 4-point chunks fold exactly 12 × 4 steps,
    never the retained history, and the result equals a fresh Path of the
    retained points."""
    cap = 16
    x = pts(93, 8, 3)
    p = Path.from_points(t(x), depth=2, retention=cap)
    history = x
    with dispatch.count_scan_steps() as scans:
        for step in range(12):
            chunk = pts(94 + step, 4, 3)
            history = np.concatenate([history, chunk])
            p = p.update(t(chunk))
            assert len(p) <= cap and p.capacity <= 2 * cap
    assert scans.total == 12 * 4
    fresh = Path.from_points(t(history[-len(p):]), depth=2)
    for i, j in [(0, None), (3, 11)]:
        close(p.signature(i, j), fresh.signature(i, j), 1e-10)
    close(p.signature(), rt.signature(t(history[-len(p):]), 2), 1e-10)


def test_retention_error_does_not_grow_with_evictions():
    """80 evictions in float32 on unit-scale random walks stay at the
    rounding of one splice against a fresh Path of the retained points.
    (Reading the pivot's inverse from the inverse store, as the JAX package
    does, multiplies the error by about 2 an eviction here.)"""
    walk = np.cumsum(pts(98, 120, 3, scale=0.15, dtype=np.float32), axis=0)
    p = Path.from_points(t(walk[:40]), depth=3, retention=40)
    for i in range(40, 120):
        p = p.update(t(walk[i:i + 1]))
    fresh = Path.from_points(t(walk[-40:]), depth=3)
    for i, j in [(0, None), (5, 30), (20, 40)]:
        close(p.signature(i, j), fresh.signature(i, j), 5e-5)


def test_retention_vs_jax():
    x = pts(93, 8, 3)
    chunks = [pts(94 + s, 4, 3) for s in range(5)]
    p = Path.from_points(t(x), depth=2, retention=16)
    for c in chunks:
        p = p.update(t(c))
    with jax.enable_x64(True):
        jp = JPath.from_points(jnp.asarray(x), depth=2, retention=16)
        for c in chunks:
            jp = jp.update(jnp.asarray(c))
        assert len(p) == int(jp.length)
        close(p.signature(), jp.signature(), 1e-10)
        close(p.signature(2, 9), jp.signature(2, 9), 1e-10)


def test_retention_validation():
    x = t(pts(95, 10, 2))
    for bad in (1, 0, -3, 2.5, True):
        with pytest.raises(ValueError, match="retention"):
            Path.from_points(x, depth=2, retention=bad)
    with pytest.raises(ValueError, match="retention"):
        Path.from_points(x, depth=2, retention=8)
    Path.from_points(x, depth=2, retention=10)


def test_call_counters_reset():
    Path.from_points(t(pts(1, 5, 2)), depth=2).signature(1, 4)
    assert sum(trace_counts().values()) > 0
    reset_trace_counts()
    assert trace_counts() == {"build": 0, "update": 0, "query": 0, "evict": 0}
