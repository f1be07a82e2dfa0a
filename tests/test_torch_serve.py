"""The port's ``SigFeatureServer`` against the JAX package's.

The same numpy streams and ticks go through ``repro.serve`` and
``repro_torch.serve`` (``device="cpu"``).  Float64 cases run inside
``jax.enable_x64(True)`` and hold to 1e-10 relative.  The server contract:
appends queue until ``flush()``, which applies them as one coalesced update
a (capacity, chunk bucket) group, streams that must grow going alone; the
results equal per-stream updates; ``features()`` equals the offline
``rff_features`` of the same window.  The port counts its batched
operations on every call, so the steady state is held to one update call a
group, not to JAX's flat trace counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro.serve import SigFeatureServer as JServer
from repro_torch.core import features as ft
from repro_torch.serve import SigFeatureServer
from repro_torch.stream import trace_counts


def pts(seed, n, d, scale=0.3):
    return np.random.default_rng(seed).normal(size=(n, d)) * scale


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def servers(n=4, depth=3, d=2, **kw):
    """A port server and (under x64) a JAX server with the same n streams."""
    srv = SigFeatureServer(depth, device="cpu", **kw)
    data = {f"s{s}": pts(100 + s, 9 + s, d) for s in range(n)}
    for name, x in data.items():
        srv.open_stream(name, t(x))
    return srv, data


def jax_server(data, depth=3, **kw):
    jsrv = JServer(depth, **kw)
    for name, x in data.items():
        jsrv.open_stream(name, jnp.asarray(x))
    return jsrv


# ---------------------------------------------------------------------------
# admission batching
# ---------------------------------------------------------------------------

def test_flush_coalesces_and_matches_jax():
    srv, data = servers()
    ticks = {name: pts(200 + i, 1, 2) for i, name in enumerate(data)}
    for name, tick in ticks.items():
        srv.append(name, t(tick))
    assert srv.flush() == len(data)
    st = srv.stats()
    assert st["update_groups"] == 1 and st["coalesced_streams"] == 4
    assert st["solo_updates"] == 0 and st["pending_streams"] == 0
    with jax.enable_x64(True):
        jsrv = jax_server(data)
        for name, tick in ticks.items():
            jsrv.append(name, jnp.asarray(tick))
        jsrv.flush()
        for name in data:
            close(srv.signature(name), jsrv.signature(name), 1e-10)
    for name in data:
        full = t(np.concatenate([data[name], ticks[name]]))
        close(srv.signature(name), rt.signature(full, 3, backend="reference"), 1e-12)


def test_flush_groups_by_capacity_and_chunk_bucket():
    srv = SigFeatureServer(2, device="cpu")
    lengths = {"a": 9, "b": 12, "c": 20, "d": 21, "e": 10}    # capacities 16, 16, 32, 32, 16
    for i, (name, n) in enumerate(lengths.items()):
        srv.open_stream(name, t(pts(i, n, 2)))
    chunks = {"a": 1, "b": 1, "c": 3, "d": 4, "e": 2}        # buckets 1, 1, 4, 4, 2
    for i, (name, k) in enumerate(chunks.items()):
        srv.append(name, t(pts(10 + i, k, 2)))
    before = trace_counts()["update"]
    assert srv.flush() == 5
    st = srv.stats()
    # groups: (16, 1) = {a, b}, (16, 2) = {e}, (32, 4) = {c, d}
    assert st["update_groups"] == 3 and st["coalesced_streams"] == 5
    assert trace_counts()["update"] - before == 3        # one batched call a group
    for i, (name, n) in enumerate(lengths.items()):
        full = np.concatenate([pts(i, n, 2), pts(10 + i, chunks[name], 2)])
        assert len(srv.path(name)) == full.shape[0]
        close(srv.signature(name), rt.signature(t(full), 2), 1e-12)


def test_steady_state_is_one_update_call_a_flush():
    srv, data = servers(n=3, d=4, depth=2)
    for step in range(4):
        before = trace_counts()
        for name in data:
            srv.append(name, t(pts(301 + step, 1, 4)))
        srv.flush()
        after = trace_counts()
        assert after["update"] - before["update"] == 1
        assert after["build"] == before["build"]


def test_multiple_appends_per_stream_concatenate():
    srv, data = servers(n=1)
    a, b = pts(400, 2, 2), pts(401, 3, 2)
    srv.append("s0", t(a))
    srv.append("s0", t(b))
    srv.flush()
    full = np.concatenate([data["s0"], a, b])
    assert len(srv.path("s0")) == full.shape[0]
    close(srv.signature("s0"), rt.signature(t(full), 3), 1e-12)


def test_growth_routes_solo_and_matches_jax():
    srv, data = servers(n=2)
    big, tick = pts(500, 20, 2), pts(501, 1, 2)
    srv.append("s0", t(big))
    srv.append("s1", t(tick))
    srv.flush()
    assert srv.stats()["solo_updates"] == 1
    with jax.enable_x64(True):
        jsrv = jax_server(data)
        jsrv.append("s0", jnp.asarray(big))
        jsrv.append("s1", jnp.asarray(tick))
        jsrv.flush()
        for name in data:
            close(srv.signature(name), jsrv.signature(name), 1e-10)
    close(srv.signature("s0"), rt.signature(t(np.concatenate([data["s0"], big])), 3), 1e-12)


def test_single_tick_accepts_1d_points():
    srv, data = servers(n=1)
    srv.append("s0", torch.tensor([0.1, -0.2], dtype=torch.float64))
    srv.flush()
    assert len(srv.path("s0")) == data["s0"].shape[0] + 1


# ---------------------------------------------------------------------------
# queries and features
# ---------------------------------------------------------------------------

def test_query_modes_match_jax():
    x = pts(600, 12, 2)
    srv = SigFeatureServer(2, transforms=rt.TransformPipeline(lead_lag=True), device="cpu")
    srv.open_stream("x", t(x))
    with jax.enable_x64(True):
        jsrv = JServer(2, transforms=repro.TransformPipeline(lead_lag=True))
        jsrv.open_stream("x", jnp.asarray(x))
        close(srv.signature("x", 3, 9), jsrv.signature("x", 3, 9), 1e-10)
        for mode in ("lyndon", "brackets", "expand"):
            close(srv.logsignature("x", 0, 7, mode=mode),
                  jsrv.logsignature("x", 0, 7, mode=mode), 1e-10)
        roll = srv.rolling("x", 4, stride=2)
        assert roll.shape[0] == 5
        close(roll, jsrv.rolling("x", 4, stride=2), 1e-10)
    assert srv.stats()["queries"] == 5


def test_features_match_offline_rff():
    feats = rt.FeatureConfig(method="rff", rank=8, depth=2)
    srv = SigFeatureServer(2, features=feats, device="cpu")
    x = t(pts(601, 10, 3))
    srv.open_stream("x", x)
    want = ft.rff_features(x[-6:][None], feats, srv.transforms, srv.static_kernel)[0]
    assert torch.equal(srv.features("x", window=6), want)
    want_full = ft.rff_features(x[None], feats, srv.transforms, srv.static_kernel)[0]
    assert torch.equal(srv.features("x"), want_full)
    srv.append("x", t(pts(602, 3, 3)))
    srv.flush()
    grown = torch.cat([x, t(pts(602, 3, 3))])
    assert torch.equal(srv.features("x", window=5),
                       ft.rff_features(grown[-5:][None], feats, srv.transforms,
                                       srv.static_kernel)[0])
    assert srv.stats()["feature_requests"] == 3


def test_features_with_rbf_lift_and_lead_lag():
    feats = rt.FeatureConfig(method="rff", rank=4, depth=2, lift_dim=8)
    tp = rt.TransformPipeline(lead_lag=True)
    srv = SigFeatureServer(2, features=feats, transforms=tp, static_kernel=rt.RBF(0.7),
                           device="cpu")
    x = t(pts(603, 9, 2))
    srv.open_stream("x", x)
    assert torch.equal(srv.features("x", window=4),
                       ft.rff_features(x[-4:][None], feats, tp, rt.RBF(0.7))[0])


def test_server_validation():
    with pytest.raises(ValueError, match="rff"):
        SigFeatureServer(2, features=rt.FeatureConfig(method="nystroem", rank=4),
                         device="cpu")
    srv = SigFeatureServer(2, device="cpu")
    with pytest.raises(KeyError, match="unknown stream"):
        srv.signature("nope")
    x = t(pts(700, 8, 2))
    srv.open_stream("x", x)
    with pytest.raises(ValueError, match="already open"):
        srv.open_stream("x", x)
    with pytest.raises(ValueError, match="no FeatureConfig"):
        srv.features("x")
    with pytest.raises(ValueError, match="append expects"):
        srv.append("x", t(pts(701, 2, 3)))
    srv.close_stream("x")
    assert srv.stats()["streams"] == 0
    with pytest.raises(KeyError, match="unknown stream"):
        srv.append("x", x[:1])
    srv2 = SigFeatureServer(2, features=rt.FeatureConfig(method="rff", rank=4), device="cpu")
    srv2.open_stream("y", x)
    with pytest.raises(ValueError, match="window"):
        srv2.features("y", window=100)
    with pytest.raises(ValueError, match="streams are single paths"):
        srv2.open_stream("z", x[None])


def test_server_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert SigFeatureServer(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SigFeatureServer(2)


def test_warmup_runs_build_and_update():
    srv = SigFeatureServer(2, device="cpu")
    srv.open_stream("a", t(pts(800, 10, 2)))
    before = trace_counts()
    secs = srv.warmup(lengths=(16,), chunk_sizes=(1, 2), group_sizes=(2,))
    after = trace_counts()
    assert secs >= 0.0
    assert after["build"] - before["build"] == 2
    assert after["update"] - before["update"] == 2
