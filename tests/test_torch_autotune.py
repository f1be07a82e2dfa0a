"""The port's autotune cache and ``error_budget=`` against the JAX package's
(``repro.bench.autotune``, ``repro.core.dispatch``), on the CPU.

Every test points ``REPRO_AUTOTUNE_CACHE`` at a file under ``tmp_path``
(the ``cache`` fixture), so none reads or writes the home directory's
cache.  The models are ``tests/test_autotune.py``, ``test_features.py``'s
frontier tests and ``test_schemes.py``'s budget-hook tests: keys letter for
letter; a cold cache tunes and persists; a warm one times nothing; every
fail-open case gives the static rule; the two budget lookups answer as the
JAX functions do on the same entries; a budgeted Gram with a warm scheme
entry agrees with the JAX package's on the same numpy inputs (f32 5e-5 and
bf16 1e-2 relative, the repo's value gates); with a warm frontier entry the
budgeted call is bit for bit the explicit ``features=`` call (the two
packages' draws never agree); on a cold cache every budgeted entry point is
bit for bit the call without the budget; the conflict and refusal errors;
the scheme frontier's errors against the JAX package's on shared inputs
(1e-5); and a point that fails makes the tuning call raise.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch as rt
from repro.bench import autotune as jat
from repro.core import dispatch as jdispatch
from repro.core.config import GridConfig as JGridConfig
from repro.core.gram import sigkernel_gram as j_gram
from repro.core.losses import mmd2 as j_mmd2
from repro_torch.bench import autotune, timer
from repro_torch.core import dispatch
from repro_torch.core import gram as tgram
from repro_torch.core.features import FeatureConfig

#: tiny sig-kernel key shape (buckets to (8, 8, 2)); tuning it measures both
#: CPU candidates in well under a second
SHAPE = (6, 6, 2)
GRAM_SHAPE = (4, 4, 8, 8, 2)
#: the repo's value gates between the packages (PERF.md §2)
VAL_TOL = {"float32": 5e-5, "bfloat16": 1e-2}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(path))
    monkeypatch.delenv(autotune.ENV_DISABLE, raising=False)
    autotune.invalidate_memo()
    jat.invalidate_memo()
    yield path
    autotune.invalidate_memo()
    jat.invalidate_memo()


def _write(path, entries, schema=autotune.SCHEMA):
    path.write_text(json.dumps({"schema": schema, "entries": entries}), encoding="utf-8")
    autotune.invalidate_memo()
    jat.invalidate_memo()


def _np_paths(seed, B, L, d, scale=0.2):
    return (np.random.default_rng(seed).normal(size=(B, L, d)) * scale).astype(np.float32)


def _pair(seed, B=3, L=6, d=2, By=2):
    x, y = _np_paths(seed, B, L, d), _np_paths(seed + 100, By, L, d)
    return x, y, torch.from_numpy(x), torch.from_numpy(y)


def _bitwise(a, b):
    a, b = a.detach(), b.detach()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a - b).abs().max())


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

KEY_CASES = [("signature", (30, 3, 5)), ("logsignature", (100, 7, 6)),
             ("sigkernel", (6, 6, 2)), ("sigkernel", (127, 255, 8)),
             ("gram", (4, 4, 12, 12, 3)), ("gram", (128, 128, 255, 255, 8))]
SUFFIXES = [{}, {"ragged": True}, {"approx": True}, {"scheme": True},
            {"ragged": True, "approx": True}, {"ragged": True, "scheme": True}]


@pytest.mark.parametrize("op, shape", KEY_CASES)
@pytest.mark.parametrize("suffix", SUFFIXES, ids=lambda s: "+".join(s) or "exact")
def test_keys_equal_jax_letter_for_letter(op, shape, suffix):
    assert autotune.bucket(shape) == jat.bucket(shape)
    assert autotune.key_shape(op, shape) == jat.key_shape(op, shape)
    for tdt, jdt in (("float32", "float32"), (torch.float32, jnp.float32),
                     (torch.float64, np.float64)):
        assert autotune.cache_key(op, shape, tdt, device="cpu", **suffix) == \
            jat.cache_key(op, shape, jdt, **suffix)
    assert autotune.cache_key(op, shape, device="cuda", **suffix).split("|")[1] == "cuda"


def test_key_errors_equal_jax():
    for mod, kw in ((autotune, {"device": "cpu"}), (jat, {})):
        with pytest.raises(ValueError, match="unknown op"):
            mod.cache_key("conv", SHAPE, **kw)
        with pytest.raises(ValueError, match="separate"):
            mod.cache_key("gram", GRAM_SHAPE, approx=True, scheme=True, **kw)


def test_channels_and_depth_never_bucketed():
    assert autotune.key_shape("signature", (30, 3, 5)) == (32, 3, 5)
    assert autotune.key_shape("gram", (4, 4, 12, 12, 3)) == (4, 4, 16, 16, 3)
    assert autotune.dtype_name(torch.bfloat16) == "bfloat16"


# ---------------------------------------------------------------------------
# the exact winner: tune, persist, look up, fail open
# ---------------------------------------------------------------------------

def test_candidates_drop_the_cuda_kernels_off_the_card():
    cpu = autotune.candidates("gram", "cpu")
    assert set(cpu) == {"antidiag", "reference"}
    assert set(autotune.candidates("gram", "cuda")) == {"antidiag", "gpu", "gpu_fused",
                                                        "reference"}
    assert set(autotune.candidates("signature", "cuda")) == {"gpu", "reference"}
    assert cpu == tuple(jat.candidates("gram"))   # the JAX package's off the TPU


def test_cold_cache_tunes_and_persists(cache):
    assert autotune.lookup("sigkernel", SHAPE, device="cpu") is None
    winner = autotune.tune("sigkernel", SHAPE, device="cpu", repeats=1)
    assert winner in autotune.candidates("sigkernel", "cpu")
    doc = json.loads(cache.read_text())
    assert doc["schema"] == autotune.SCHEMA
    entry = doc["entries"][autotune.cache_key("sigkernel", SHAPE, device="cpu")]
    assert entry["backend"] == winner
    assert entry["machine"] == timer.machine_key("cpu")
    assert set(entry["timings"]) == set(autotune.candidates("sigkernel", "cpu"))
    assert "launch" not in entry and "launch_timings" not in entry
    assert autotune.lookup("sigkernel", (7, 5, 2), device="cpu") == winner  # same bucket
    assert autotune.lookup("sigkernel", (6, 6, 3), device="cpu") is None    # d is exact
    assert dispatch.resolve("auto", op="sigkernel", device="cpu", shape=SHAPE) == winner


def test_warm_cache_performs_zero_timed_runs(cache, monkeypatch):
    winner = autotune.tune("sigkernel", SHAPE, device="cpu", repeats=1)

    def timed(*a, **k):
        raise AssertionError("a warm cache timed a run")

    monkeypatch.setattr(timer, "bench", timed)
    assert autotune.tune("sigkernel", SHAPE, device="cpu", repeats=1) == winner
    assert autotune.lookup("sigkernel", SHAPE, device="cpu") == winner
    assert dispatch.resolve("auto", op="sigkernel", device="cpu", shape=SHAPE) == winner
    x, y = torch.zeros(2, 7, 2), torch.ones(2, 7, 2) * 0.1
    _bitwise(rt.sigkernel(x, y), rt.sigkernel(x, y, backend=winner))


def test_ragged_key_is_kept_apart(cache):
    dense = autotune.cache_key("sigkernel", SHAPE, device="cpu")
    assert autotune.cache_key("sigkernel", SHAPE, device="cpu", ragged=True) == \
        dense + "|ragged"
    winner = autotune.tune("sigkernel", SHAPE, device="cpu", repeats=1, ragged=True)
    assert autotune.lookup("sigkernel", SHAPE, device="cpu", ragged=True) == winner
    assert autotune.lookup("sigkernel", SHAPE, device="cpu") is None


def _plant_jax_format(path, name):
    """The JAX package's own writer, at the same path."""
    jat._store(jat.cache_key("sigkernel", SHAPE), {"backend": name})
    autotune.invalidate_memo()


FAIL_OPEN = ["corrupt_file", "jax_format_file", "stale_backend_name",
             "cuda_winner_on_cpu_tensors", "disabled_env", "foreign_machine_stamp"]


@pytest.mark.parametrize("case", FAIL_OPEN)
def test_fail_open_gives_the_static_rule(cache, monkeypatch, case):
    """Each case plants a winner that the static rule would not pick at 16
    cells ("antidiag" where it is live) and must read as a cold cache."""
    key = autotune.cache_key("sigkernel", SHAPE, device="cpu")
    planted = {"corrupt_file": None, "jax_format_file": None,
               "stale_backend_name": {"backend": "renamed_away"},
               "cuda_winner_on_cpu_tensors": {"backend": "gpu"},
               "disabled_env": {"backend": "antidiag"},
               "foreign_machine_stamp": {"backend": "antidiag",
                                         "machine": "cuda|another card|1"}}[case]
    if case == "corrupt_file":
        cache.write_text("{ this is not json", encoding="utf-8")
        autotune.invalidate_memo()
    elif case == "jax_format_file":
        _plant_jax_format(cache, "antidiag")
        assert jat.lookup("sigkernel", SHAPE) == "antidiag"   # JAX reads it
    else:
        _write(cache, {key: planted})
    if case == "disabled_env":
        monkeypatch.setenv(autotune.ENV_DISABLE, "1")
        assert not autotune.enabled()
    if case in ("corrupt_file", "jax_format_file", "disabled_env",
                "foreign_machine_stamp"):
        assert autotune.lookup("sigkernel", SHAPE, device="cpu") is None
    assert dispatch.resolve("auto", op="sigkernel", device="cpu", shape=SHAPE,
                            grid_cells=16) == "reference"
    assert dispatch.resolve("auto", op="sigkernel", device="cpu", shape=SHAPE,
                            grid_cells=1 << 20) == "antidiag"
    # the lookup itself never raises, and a tune recovers
    if case != "disabled_env":
        winner = autotune.tune("sigkernel", SHAPE, device="cpu", repeats=1, force=True)
        assert dispatch.resolve("auto", op="sigkernel", device="cpu", shape=SHAPE) == winner


def test_the_jax_package_reads_a_port_file_as_cold(cache):
    autotune.tune("sigkernel", SHAPE, device="cpu", repeats=1)
    jat.invalidate_memo()
    assert jat.lookup("sigkernel", SHAPE) is None


GUARDED = [("approximate", "gram", "rff", {}, "cpu"),
           ("fused_where_not_allowed", "gram", "gpu_fused", {"allow_fused": False}, "cuda"),
           ("lacks_the_scheme", "sigkernel", "order1_only", {"scheme": "order2"}, "cpu")]


@pytest.mark.parametrize("what, op, name, kw, device", GUARDED, ids=[g[0] for g in GUARDED])
def test_guarded_winners_give_the_static_rule(cache, monkeypatch, what, op, name, kw, device):
    """A stampless (hand-written) entry is accepted, so on "cuda" the lookup
    needs no card; the winner is taken where the guard does not apply."""
    monkeypatch.setitem(dispatch._REGISTRY, "order1_only", dispatch.BackendSpec(
        "order1_only", frozenset(dispatch.PDE_OPS), needs_cuda=False,
        schemes=frozenset({"order1"})))
    shape = GRAM_SHAPE if op == "gram" else SHAPE
    _write(cache, {autotune.cache_key(op, shape, device=device): {"backend": name}})
    static = dispatch.resolve("auto", op=op, device=device, grid_cells=16, **kw)
    assert dispatch.resolve("auto", op=op, device=device, shape=shape, grid_cells=16,
                            **kw) == static != name
    if what != "approximate":
        assert dispatch.resolve("auto", op=op, device=device, shape=shape,
                                grid_cells=16) == name


def test_auto_fused_winner_degrades_on_broadcast_batches(monkeypatch):
    """A tuned "gpu_fused" sigkernel winner (the key has no batch shape)
    falls back to the static rule on broadcast batches; an explicit request
    still raises."""
    monkeypatch.setattr(dispatch, "_autotuned",
                        lambda op, shape, dtype, device, ragged=False:
                        "gpu_fused" if shape is not None else None)
    x, y = torch.from_numpy(_np_paths(0, 1, 6, 2)), torch.from_numpy(_np_paths(1, 5, 6, 2))
    _bitwise(rt.sigkernel(x, y), rt.sigkernel(x, y, backend="reference"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rt.sigkernel(x, y, backend="gpu_fused")


# ---------------------------------------------------------------------------
# the budget lookups against the JAX package's on the same entries
# ---------------------------------------------------------------------------

FRONTIER = [{"backend": "rff", "rank": 8, "rel_err": 0.30, "seconds": 0.01},
            {"backend": "rff", "rank": 64, "rel_err": 0.05, "seconds": 0.05},
            {"backend": "nystroem", "rank": 16, "rel_err": 0.02, "seconds": 0.20},
            {"backend": "nystroem", "rank": 99, "rel_err": 0.001, "seconds": 5.0},
            {"backend": "rff", "rank": "many", "rel_err": 0.0, "seconds": 0.0}, "junk"]
SCHEMES = [{"scheme": "order1", "coarsen": 1, "interior_dtype": "bfloat16",
            "rel_err": 0.03, "seconds": 0.1},
           {"scheme": "order2", "coarsen": 1, "interior_dtype": "float32",
            "rel_err": 0.004, "seconds": 0.3},
           {"scheme": "order1", "coarsen": 0, "interior_dtype": "bfloat16",
            "rel_err": 0.02, "seconds": 0.9},
           {"scheme": "order2", "coarsen": 0, "interior_dtype": "float32",
            "rel_err": 0.0, "seconds": 2.0},
           {"scheme": "order2"}]


def _both_answers(cache, tmp_path, monkeypatch, entry, approx, budget, ragged=False):
    """(port, JAX) lookups on the same entry, each package in its own file."""
    flag = {"approx": True} if approx else {"scheme": True}
    port_lookup = autotune.lookup_budget if approx else autotune.lookup_scheme_budget
    jax_lookup = jat.lookup_budget if approx else jat.lookup_scheme_budget
    _write(cache, {autotune.cache_key("gram", GRAM_SHAPE, device="cpu", ragged=ragged,
                                      **flag): entry})
    got = port_lookup("gram", GRAM_SHAPE, "float32", budget, device="cpu", ragged=ragged)
    jfile = tmp_path / "jax.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(jfile))
    _write(jfile, {jat.cache_key("gram", GRAM_SHAPE, ragged=ragged, **flag): entry},
           schema=jat.SCHEMA)
    want = jax_lookup("gram", GRAM_SHAPE, "float32", budget, ragged=ragged)
    monkeypatch.setenv(autotune.ENV_CACHE, str(cache))
    return got, want


BUDGETS = [None, 1e-4, 0.005, 0.03, 0.1, 0.5]


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("approx", [True, False], ids=["frontier", "scheme_frontier"])
def test_budget_lookups_equal_jax(cache, tmp_path, monkeypatch, budget, approx):
    entry = {"exact_seconds": 1.0, "frontier" if approx else "scheme_frontier":
             FRONTIER if approx else SCHEMES}
    got, want = _both_answers(cache, tmp_path, monkeypatch, entry, approx, budget)
    assert got == (None if want is None else tuple(want))
    got, want = _both_answers(cache, tmp_path, monkeypatch, entry, approx, budget,
                              ragged=True)
    assert got == (None if want is None else tuple(want))


@pytest.mark.parametrize("approx", [True, False], ids=["frontier", "scheme_frontier"])
def test_budget_lookups_drop_foreign_and_malformed_entries(cache, tmp_path, monkeypatch,
                                                           approx):
    field = "frontier" if approx else "scheme_frontier"
    points = FRONTIER if approx else SCHEMES
    for entry in ({"exact_seconds": 1.0, field: points, "machine": "someone-elses-box"},
                  {"exact_seconds": "fast", field: points},
                  {"exact_seconds": 1.0, field: "not a list"}):
        got, want = _both_answers(cache, tmp_path, monkeypatch, entry, approx, 0.5)
        assert got is None and want is None
    entry = {"exact_seconds": 1.0, field: points, "machine": timer.machine_key("cpu")}
    got, _ = _both_answers(cache, tmp_path, monkeypatch, entry, approx, 0.5)
    assert got is not None      # this machine's stamp is accepted


def test_resolvers_validate_against_the_registry(cache):
    _write(cache, {
        autotune.cache_key("gram", GRAM_SHAPE, device="cpu", approx=True):
            {"exact_seconds": 1.0, "frontier": [
                {"backend": "reference", "rank": 8, "rel_err": 0.0, "seconds": 0.1}]},
        autotune.cache_key("gram", GRAM_SHAPE, device="cpu", scheme=True):
            {"exact_seconds": 1.0, "scheme_frontier": [
                {"scheme": "order9", "coarsen": 1, "interior_dtype": "float32",
                 "rel_err": 0.0, "seconds": 0.1}]}})
    assert autotune.lookup_budget("gram", GRAM_SHAPE, "float32", 0.5,
                                  device="cpu") == ("reference", 8)
    assert dispatch.resolve_approx("gram", GRAM_SHAPE, "float32", device="cpu",
                                   error_budget=0.5) is None
    assert dispatch.resolve_scheme("gram", GRAM_SHAPE, "float32", device="cpu",
                                   error_budget=0.5) is None


# ---------------------------------------------------------------------------
# error_budget= on the entry points
# ---------------------------------------------------------------------------

def _gram_key(X, Y, lam=0):
    L = X.shape[1] - 1
    return (X.shape[0], Y.shape[0], L << lam, L << lam, X.shape[2])


SCHEME_HOOKS = [  # (scheme point, grid of the call, the explicit grid it replays, slice)
    (("order2", 1, "bfloat16"), (2, 2), (1, 1, "order2", "bfloat16"), 1),
    (("order1", 1, "float32"), (0, 0), (0, 0, "order1", "float32"), 2),
    (("order2", 1, "float32"), (0, 0), (0, 0, "order2", "float32"), 2),
    (("order1", 0, "bfloat16"), (1, 0), (1, 0, "order1", "bfloat16"), 1),
]


@pytest.mark.parametrize("point, lam, explicit, step", SCHEME_HOOKS,
                         ids=["%s_c%d_%s" % h[0] for h in SCHEME_HOOKS])
def test_budgeted_gram_replays_the_scheme_point_as_jax_does(cache, tmp_path, monkeypatch,
                                                            point, lam, explicit, step):
    x, y, X, Y = _pair(16, L=7)
    key = (X.shape[0], Y.shape[0], 6 << lam[0], 6 << lam[1], 2)
    entry = {"exact_seconds": 1.0, "scheme_frontier": [
        {"scheme": point[0], "coarsen": point[1], "interior_dtype": point[2],
         "rel_err": 0.01, "seconds": 1e-4}]}
    _write(cache, {autotune.cache_key("gram", key, device="cpu", scheme=True): entry})
    grid = rt.GridConfig(*lam)
    got = rt.sigkernel_gram(X, Y, symmetric=False, grid=grid, error_budget=0.1,
                            backend="auto")
    l1, l2, sch, idt = explicit
    want_port = rt.sigkernel_gram(X[:, ::step], Y[:, ::step], symmetric=False,
                                  grid=rt.GridConfig(l1, l2, sch, idt))
    _bitwise(got, want_port)
    # the JAX package on the same entry and the same numpy inputs
    jfile = tmp_path / "jax.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(jfile))
    _write(jfile, {jat.cache_key("gram", key, scheme=True): entry}, schema=jat.SCHEMA)
    # JAX's "auto" takes its reference scan at these grids, as the port's does
    assert jdispatch.resolve("auto", op="gram", grid_cells=key[2] * key[3]) == "reference"
    want = j_gram(jnp.asarray(x), jnp.asarray(y), symmetric=False, grid=JGridConfig(*lam),
                  error_budget=0.1)
    assert _max_rel(got.numpy(), want) <= VAL_TOL[point[2]]
    # and without a qualifying point both run the exact engine
    want_exact = j_gram(jnp.asarray(x), jnp.asarray(y), symmetric=False,
                        grid=JGridConfig(*lam), error_budget=1e-9)
    monkeypatch.setenv(autotune.ENV_CACHE, str(cache))
    got_exact = rt.sigkernel_gram(X, Y, symmetric=False, grid=grid, error_budget=1e-9)
    assert _max_rel(got_exact.numpy(), want_exact) <= VAL_TOL["float32"]


def test_budgeted_mmd2_equals_jax_on_a_scheme_entry(cache, tmp_path, monkeypatch):
    x, y, X, Y = _pair(18, B=3, L=7, By=3)
    entry = {"exact_seconds": 1.0, "scheme_frontier": [
        {"scheme": "order1", "coarsen": 1, "interior_dtype": "float32",
         "rel_err": 0.01, "seconds": 1e-4}]}
    key = _gram_key(X, Y)
    _write(cache, {autotune.cache_key("gram", key, device="cpu", scheme=True): entry})
    got = rt.mmd2(X, Y, error_budget=0.1)
    _bitwise(got, rt.mmd2(X[:, ::2], Y[:, ::2], streaming=True))
    jfile = tmp_path / "jax.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(jfile))
    _write(jfile, {jat.cache_key("gram", key, scheme=True): entry}, schema=jat.SCHEMA)
    want = j_mmd2(jnp.asarray(x), jnp.asarray(y), error_budget=0.1)
    assert abs(float(got) - float(want)) <= VAL_TOL["float32"] * max(abs(float(want)), 1e-3)


def test_explicit_scheme_is_never_overridden(cache):
    x, y, X, Y = _pair(19, L=7)
    _write(cache, {autotune.cache_key("gram", _gram_key(X, Y, 2), device="cpu",
                                      scheme=True): {
        "exact_seconds": 1.0, "scheme_frontier": [
            {"scheme": "order1", "coarsen": 1, "interior_dtype": "bfloat16",
             "rel_err": 0.01, "seconds": 1e-4}]}})
    for g in (rt.GridConfig(2, 2, scheme="order2"), rt.GridConfig(2, 2, interior_dtype="bfloat16")):
        _bitwise(rt.sigkernel_gram(X, Y, symmetric=False, grid=g, error_budget=0.1),
                 rt.sigkernel_gram(X, Y, symmetric=False, grid=g))


@pytest.mark.parametrize("method, rank", [("rff", 16), ("nystroem", 2)])
def test_budgeted_calls_equal_the_explicit_feature_call(cache, method, rank):
    x, y, X, Y = _pair(20, B=3, L=7, By=3)
    entry = {"exact_seconds": 1.0, "frontier": [
        {"backend": method, "rank": rank, "rel_err": 0.05, "seconds": 0.01}]}
    # the Grams' keys, and the scoring rule's cross term against one path
    _write(cache, {autotune.cache_key("gram", key, device="cpu", approx=True): entry
                   for key in (_gram_key(X, Y), _gram_key(X, Y[:1]))})
    f = FeatureConfig(method, rank=rank)
    with dispatch.count_pair_solves() as c:
        K = rt.sigkernel_gram(X, Y, error_budget=0.1)
    _bitwise(K, rt.sigkernel_gram(X, Y, features=f))
    if method == "rff":
        assert c.total == 0
    _bitwise(rt.sigkernel_gram_reduce(X, Y, error_budget=0.1),
             rt.sigkernel_gram_reduce(X, Y, features=f))
    _bitwise(rt.mmd2(X, Y, error_budget=0.1), rt.mmd2(X, Y, features=f))
    _bitwise(rt.scoring_rule(X, Y[0], error_budget=0.1),
             rt.scoring_rule(X, Y[0], features=f))
    sk = rt.SigKernel(error_budget=0.1, device="cpu")
    _bitwise(sk.gram(X, Y), rt.sigkernel_gram(X, Y, features=f))
    _bitwise(sk.mmd2(X, Y), rt.mmd2(X, Y, features=f))
    _bitwise(sk.scoring_rule(X, Y[0]), rt.scoring_rule(X, Y[0], features=f))
    # the gradient goes through the same map
    xa, xb = X.clone().requires_grad_(), X.clone().requires_grad_()
    ga, = torch.autograd.grad(rt.mmd2(xa, Y, error_budget=0.1), xa)
    gb, = torch.autograd.grad(rt.mmd2(xb, Y, features=f), xb)
    _bitwise(ga, gb)
    # a named approximate backend takes the frontier's rank, or the default
    _bitwise(rt.sigkernel_gram(X, Y, backend=method, error_budget=0.1),
             rt.sigkernel_gram(X, Y, features=f))
    _write(cache, {})
    _bitwise(rt.sigkernel_gram(X, Y, backend=method, error_budget=0.1),
             rt.sigkernel_gram(X, Y, features=FeatureConfig(method)))


@pytest.fixture
def gloo_world1(tmp_path):
    """A one-rank gloo group in this process, for the sharded Gram."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


CALLS = {
    "sigkernel_gram": lambda X, Y, **kw: rt.sigkernel_gram(X, Y, **kw),
    "sigkernel_gram_symmetric": lambda X, Y, **kw: rt.sigkernel_gram(X, **kw),
    "sigkernel_gram_ragged": lambda X, Y, **kw: rt.sigkernel_gram(
        X, Y, lengths=[5, 7, 6], lengths_y=[7, 4], **kw),
    "sigkernel_gram_reduce": lambda X, Y, **kw: rt.sigkernel_gram_reduce(X, Y, **kw),
    "mmd2": lambda X, Y, **kw: rt.mmd2(X, Y, streaming=True, **kw),
    "scoring_rule": lambda X, Y, **kw: rt.scoring_rule(X, Y[0], streaming=True, **kw),
    "SigKernel.gram": lambda X, Y, **kw: rt.SigKernel(device="cpu", **kw).gram(X, Y),
    "SigKernel.mmd2": lambda X, Y, **kw: rt.SigKernel(device="cpu", **kw).mmd2(
        X, Y, streaming=True),
}


@pytest.mark.parametrize("call", sorted(CALLS))
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "no_point_fits"])
def test_without_a_qualifying_point_the_budget_changes_nothing(cache, call, warm):
    """Cold cache, or warm entries none of whose points fits the budget:
    bit for bit the call without ``error_budget=``."""
    x, y, X, Y = _pair(21, B=3, L=7, By=2)
    if warm:
        entries = {}
        for key in (_gram_key(X, Y), _gram_key(X, X)):
            for flag, field, pt in (("approx", "frontier", FRONTIER[0]),
                                    ("scheme", "scheme_frontier", SCHEMES[0])):
                entries[autotune.cache_key("gram", key, device="cpu", **{flag: True})] = \
                    {"exact_seconds": 1.0, field: [pt]}
        _write(cache, entries)
    _bitwise(CALLS[call](X, Y, error_budget=1e-6), CALLS[call](X, Y))


def test_sharded_gram_takes_the_budget(cache, gloo_world1):
    x, y, X, Y = _pair(22, B=3, L=7, By=2)
    _bitwise(rt.sigkernel_gram_sharded(X, Y, error_budget=0.1),
             rt.sigkernel_gram_sharded(X, Y))
    _write(cache, {autotune.cache_key("gram", _gram_key(X, Y), device="cpu", scheme=True): {
        "exact_seconds": 1.0, "scheme_frontier": [
            {"scheme": "order1", "coarsen": 1, "interior_dtype": "float32",
             "rel_err": 0.01, "seconds": 1e-4}]}})
    _bitwise(rt.sigkernel_gram_sharded(X, Y, error_budget=0.1),
             rt.sigkernel_gram_sharded(X[:, ::2], Y[:, ::2]))


REFUSALS = [
    ("features_conflict", dict(backend="reference", features=FeatureConfig("rff")),
     "conflicts"),
    ("approx_without_opt_in", dict(backend="rff"), "approximate=True"),
    ("approx_budget_other_scheme", dict(backend="rff", error_budget=0.1,
                                        grid=rt.GridConfig(scheme="order2")),
     "does not implement"),
    ("fused_with_rbf", dict(backend="gpu_fused", static_kernel=rt.RBF(1.0)),
     "linear lift"),
]


@pytest.mark.parametrize("what, kw, match", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_conflicts_and_refusals_as_in_jax(cache, what, kw, match):
    x, y, X, Y = _pair(23)
    with pytest.raises(ValueError, match=match):
        rt.sigkernel_gram(X, Y, **kw)
    jkw = dict(kw, backend={"gpu_fused": "pallas_fused"}.get(kw["backend"], kw["backend"]))
    if "features" in jkw:
        from repro.core.features import FeatureConfig as JFeatureConfig
        jkw["features"] = JFeatureConfig("rff")
    if "grid" in jkw:
        jkw["grid"] = JGridConfig(scheme="order2")
    if "static_kernel" in jkw:
        from repro.core.config import RBF as JRBF
        jkw["static_kernel"] = JRBF(1.0)
    with pytest.raises(ValueError, match=match):
        j_gram(jnp.asarray(x), jnp.asarray(y), **jkw)


# ---------------------------------------------------------------------------
# the frontiers
# ---------------------------------------------------------------------------

def test_scheme_points_follow_the_jax_preconditions():
    assert autotune.scheme_points((4, 4, 12, 12, 3)) == autotune._SCHEME_POINTS
    assert autotune.scheme_points((4, 4, 12, 12, 3), ragged=True) == tuple(
        p for p in autotune._SCHEME_POINTS if p[1] == 0)
    assert autotune.scheme_points((2, 2, 1, 1, 2)) == tuple(
        p for p in autotune._SCHEME_POINTS if p[1] == 0)   # 2 points -> 1 after ::2


@pytest.mark.parametrize("fn", ["tune_frontier", "tune_scheme_frontier"])
def test_frontiers_take_only_the_gram(fn):
    for mod, kw in ((autotune, {"device": "cpu"}), (jat, {})):
        with pytest.raises(ValueError, match="gram"):
            getattr(mod, fn)("sigkernel", (8, 8, 2), **kw)


SMOKE = (4, 4, 12, 12, 3)


def test_scheme_frontier_errors_equal_jax(cache, tmp_path, monkeypatch):
    """Both packages' scheme frontiers at the smoke cell on the same numpy
    inputs: the same points, each relative error within 1e-5."""
    bshape = autotune.key_shape("gram", SMOKE)
    Bx, By, nx, ny, d = bshape
    x, y = _np_paths(30, Bx, nx + 1, d, 0.1), _np_paths(31, By, ny + 1, d, 0.1)
    monkeypatch.setattr(autotune, "_frontier_data", lambda shape, dtype, ragged, device: (
        torch.from_numpy(x), torch.from_numpy(y), None, None))
    monkeypatch.setattr(jat, "_frontier_data", lambda shape, dtype, ragged: (
        jnp.asarray(x), jnp.asarray(y), None, None))
    got = autotune.tune_scheme_frontier("gram", SMOKE, device="cpu", repeats=1, warmup=0)
    monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "jax.json"))
    jat.invalidate_memo()
    want = jat.tune_scheme_frontier("gram", SMOKE, repeats=1, warmup=0)
    assert got["exact_backend"] == want["exact_backend"] == "reference"
    pts = lambda e: [(p["scheme"], p["coarsen"], p["interior_dtype"])
                     for p in e["scheme_frontier"]]
    assert pts(got) == pts(want) == list(autotune._SCHEME_POINTS)
    for p, q in zip(got["scheme_frontier"], want["scheme_frontier"]):
        assert abs(p["rel_err"] - q["rel_err"]) <= 1e-5, (p, q)
    assert got["machine"] == timer.machine_key("cpu")


def test_frontiers_persist_and_answer_the_budget(cache):
    e = autotune.tune_frontier("gram", SMOKE, device="cpu", ranks=(8,), repeats=1)
    assert [(p["backend"], p["rank"]) for p in e["frontier"]] == [("nystroem", 8), ("rff", 8)]
    assert all(np.isfinite(p["rel_err"]) and p["seconds"] > 0 for p in e["frontier"])
    assert autotune.tune_frontier("gram", SMOKE, device="cpu") == e   # warm: stored
    s = autotune.tune_scheme_frontier("gram", SMOKE, device="cpu", repeats=1)
    assert autotune.tune_scheme_frontier("gram", SMOKE, device="cpu") == s
    fastest = min((p for p in s["scheme_frontier"] if p["seconds"] <= s["exact_seconds"]),
                  key=lambda p: p["seconds"], default=None)
    found = autotune.lookup_scheme_budget("gram", SMOKE, "float32", 1.0, device="cpu")
    assert found == (None if fastest is None else
                     (fastest["scheme"], fastest["coarsen"], fastest["interior_dtype"]))


class Boom(RuntimeError):
    pass


def _raise_for(pred):
    real = tgram.sigkernel_gram

    def gram(*a, **kw):
        if pred(kw):
            raise Boom("a point failed")
        return real(*a, **kw)
    return gram


RAISING = {
    "tune": lambda: autotune.tune("gram", SMOKE, device="cpu", repeats=1, force=True),
    "tune_frontier": lambda: autotune.tune_frontier("gram", SMOKE, device="cpu",
                                                    ranks=(8,), repeats=1, force=True),
    "tune_scheme_frontier": lambda: autotune.tune_scheme_frontier(
        "gram", SMOKE, device="cpu", repeats=1, force=True),
}
PREDICATES = {
    "tune": lambda kw: kw.get("backend") == "antidiag",
    "tune_frontier": lambda kw: kw.get("features") is not None
    and kw["features"].method == "rff",
    "tune_scheme_frontier": lambda kw: kw.get("grid") is not None
    and kw["grid"].scheme == "order2",
}


@pytest.mark.parametrize("fn", sorted(RAISING))
def test_a_failing_point_raises_never_skips(cache, monkeypatch, fn):
    monkeypatch.setattr(tgram, "sigkernel_gram", _raise_for(PREDICATES[fn]))
    with pytest.raises(Boom):
        RAISING[fn]()
    assert not os.path.exists(cache)      # nothing was persisted
