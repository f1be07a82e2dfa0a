"""The port's approximate feature maps (RFF / Nyström), their Gram and loss
entry points, ``sig_aux_loss`` and the ``approximate`` refusal, against the
JAX package's.

``jax.random`` and ``torch.Generator`` never draw the same numbers, so the
parity cases make the JAX package's own draws from its key (as
``repro.core.features`` makes them) and feed them, as numpy, to the port's
functions that take draws as tensors (``rff_features(draws=)``,
``gram._nystroem_maps(pool_idx=)``).  Float64 cases run inside
``jax.enable_x64(True)`` and hold to 1e-10 relative; float32 values to
5e-5 and gradients to 2e-5.  JAX gradients go through its ``"reference"``
backend (the Pallas backward does not run on the installed jax).  The
port's own draws are checked for what they promise: the same seed gives the
same map, and the estimates approach the exact Gram.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro_torch.core import dispatch
from repro_torch.core import features as ft
from repro_torch.core import gram as tgram
from repro_torch.core import losses as tlosses

jft = importlib.import_module("repro.core.features")
jgram = importlib.import_module("repro.core.gram")
jlosses = importlib.import_module("repro.core.losses")

B, L, D = 4, 9, 2

KERNELS = {
    "linear": (rt.Linear(), repro.Linear()),
    "linear_scaled": (rt.Linear(0.5), repro.Linear(0.5)),
    "rbf": (rt.RBF(0.8), repro.RBF(0.8)),
}


def paths(seed, b, n, d, scale=0.3, dtype=np.float64):
    return (np.random.default_rng(seed).normal(size=(b, n, d)) * scale).astype(dtype)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def rel_fro(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def jax_rff_draws(jfeats, jkernel, d, dtype):
    """The draws repro.core.features.rff_features makes from its key."""
    k_lift, k_proj = jax.random.split(jfeats.resolved_key())
    w = b = None
    m = d
    if isinstance(jkernel, repro.RBF):
        kw, kb = jax.random.split(k_lift)
        m = jfeats.lift_dim
        w = jax.random.normal(kw, (d, m), dtype)
        b = jax.random.uniform(kb, (m,), dtype, 0.0, 2.0 * jnp.pi)
    proj = jax.random.normal(k_proj, (jfeats.rank, jfeats.depth, m), dtype)
    return ft.RFFDraws(t(w), t(b), t(proj))


def both_feats(method, rank, **kw):
    return (rt.FeatureConfig(method, rank=rank, **kw),
            jft.FeatureConfig(method, rank=rank, key=jax.random.PRNGKey(3), **kw))


# ---------------------------------------------------------------------------
# the config object and the capability flag
# ---------------------------------------------------------------------------

def test_feature_config_validation():
    with pytest.raises(ValueError, match="method"):
        rt.FeatureConfig(method="svd")
    with pytest.raises(ValueError, match="rank"):
        rt.FeatureConfig(rank=0)
    with pytest.raises(ValueError, match="depth"):
        rt.FeatureConfig(depth=True)
    with pytest.raises(ValueError, match="seed"):
        rt.FeatureConfig(seed=-1)
    with pytest.raises(TypeError, match="FeatureConfig"):
        rt.sigkernel_gram(t(paths(0, B, L, D)), features={"method": "rff"})
    f = rt.FeatureConfig("nystroem", rank=8)
    assert f.pool_size(100) == 32 and f.feature_dim(5) == 5
    assert rt.FeatureConfig(rank=8, depth=3).feature_dim(7) == 25


def test_explicit_approx_backend_refused_without_opt_in():
    X, Y = t(paths(0, B, L, D)), t(paths(1, B + 1, L, D))
    for name in ("rff", "nystroem"):
        with pytest.raises(ValueError, match="approximate=True"):
            dispatch.resolve(name, op="gram", device="cpu")
        with pytest.raises(ValueError, match="approximate=True"):
            rt.sigkernel_gram(X, Y, backend=name)
        with pytest.raises(ValueError, match="approximate=True"):
            rt.sigkernel_gram_reduce(X, Y, backend=name)
        with pytest.raises(ValueError, match="approximate=True"):
            rt.mmd2(X, Y, backend=name)
    with pytest.raises(ValueError, match="reference"):   # names an exact escape
        dispatch.resolve("rff", op="gram", device="cpu")


def test_explicit_approx_backend_allowed_with_opt_in():
    assert dispatch.resolve("rff", op="gram", device="cpu", allow_approximate=True) == "rff"
    X, Y = t(paths(0, B, L, D)), t(paths(1, B + 1, L, D))
    for name in ("rff", "nystroem"):
        K = rt.sigkernel_gram(X, Y, backend=name, features=rt.FeatureConfig(name, rank=4))
        assert K.shape == (B, B + 1)


def test_features_backend_conflict_raises():
    X, Y = t(paths(0, B, L, D)), t(paths(1, B + 1, L, D))
    with pytest.raises(ValueError, match="conflicts"):
        rt.sigkernel_gram(X, Y, backend="antidiag", features=rt.FeatureConfig("rff"))
    with pytest.raises(ValueError, match="conflicts"):
        rt.sigkernel_gram(X, Y, backend="rff", features=rt.FeatureConfig("nystroem"))
    with pytest.raises(ValueError, match="order2"):
        rt.sigkernel_gram(X, Y, grid=rt.GridConfig(scheme="order2"),
                          features=rt.FeatureConfig("rff"))


@pytest.mark.parametrize("cells", [None, 16, 1 << 20])
def test_auto_never_picks_approx(cells):
    for fused in (True, False):
        name = dispatch.resolve("auto", op="gram", device="cpu", grid_cells=cells,
                                allow_fused=fused, allow_approximate=True)
        assert not dispatch.get(name).approximate
    assert {n for n in dispatch.backends_for("gram") if dispatch.get(n).approximate} \
        == {"rff", "nystroem"}


# ---------------------------------------------------------------------------
# RFF against JAX, fed the JAX draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kern", KERNELS, ids=KERNELS.keys())
def test_rff_features_match_jax_f64(kern):
    tk, jk = KERNELS[kern]
    f, jf = both_feats("rff", 16, depth=3, lift_dim=32)
    X = paths(2, B, L, D)
    with jax.enable_x64(True):
        want = jft.rff_features(jnp.asarray(X), jf, repro.TransformPipeline(), jk)
        draws = jax_rff_draws(jf, jk, D, jnp.float64)
    got = ft.rff_features(t(X), f, rt.TransformPipeline(), tk, draws=draws)
    close(got, want, 1e-10)


@pytest.mark.parametrize("kern", ["linear", "rbf"])
def test_rff_features_match_jax_f32(kern):
    tk, jk = KERNELS[kern]
    f, jf = both_feats("rff", 32)
    X = paths(3, B, L, D, dtype=np.float32)
    want = jft.rff_features(jnp.asarray(X), jf, repro.TransformPipeline(), jk)
    draws = jax_rff_draws(jf, jk, D, jnp.float32)
    close(ft.rff_features(t(X), f, rt.TransformPipeline(), tk, draws=draws), want, 5e-5)


def test_rff_features_transforms_and_ragged_match_jax():
    tk, jk = KERNELS["rbf"]
    f, jf = both_feats("rff", 8, depth=2, lift_dim=16)
    X = paths(4, B, L, D)
    lengths = np.array([5, 9, 7, 3])
    jt = repro.TransformPipeline(time_aug=True, lead_lag=True, basepoint=True, t0=0.5, t1=2.0)
    tt = rt.TransformPipeline(time_aug=True, lead_lag=True, basepoint=True, t0=0.5, t1=2.0)
    with jax.enable_x64(True):
        want = jft.rff_features(jnp.asarray(X), jf, jt, jk, jnp.asarray(lengths))
        draws = jax_rff_draws(jf, jk, jt.transformed_dim(D), jnp.float64)
    got = ft.rff_features(t(X), f, tt, tk, t(lengths), draws=draws)
    close(got, want, 1e-10)


def test_sig_projection_scan_matches_jax():
    inc = np.random.default_rng(5).normal(size=(3, 7, 4)) * 0.2
    proj = np.random.default_rng(6).normal(size=(5, 4, 4))
    with jax.enable_x64(True):
        want = jft._sig_projection_scan(jnp.asarray(inc), jnp.asarray(proj))
    close(ft._sig_projection_scan(t(inc), t(proj)), want, 1e-10)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 2e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kern", ["linear", "rbf"])
def test_rff_gradients_match_jax(kern, dtype, rtol):
    """d/dX and d/dY of Σ phi(X)·phi(Y)ᵀ, and d/dσ for the RBF lift."""
    _, jk = KERNELS[kern]
    f, jf = both_feats("rff", 16, depth=3, lift_dim=32)
    X, Y = paths(7, B, L, D, dtype=dtype), paths(8, B + 1, L, D, dtype=dtype)
    sigma = np.asarray(0.8, dtype)

    def jloss(a, b, s):
        k = repro.RBF(s) if kern == "rbf" else jk
        pa = jft.rff_features(a, jf, repro.TransformPipeline(), k)
        pb = jft.rff_features(b, jf, repro.TransformPipeline(), k)
        return jnp.sum(pa @ pb.T)

    with jax.enable_x64(dtype == np.float64):
        want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(X), jnp.asarray(Y),
                                                  jnp.asarray(sigma))
        draws = jax_rff_draws(jf, jk, D, jnp.float64 if dtype == np.float64 else jnp.float32)
    a, b, s = (t(v).clone().requires_grad_() for v in (X, Y, sigma))
    k = rt.RBF(s) if kern == "rbf" else rt.Linear()
    pa = ft.rff_features(a, f, rt.TransformPipeline(), k, draws=draws)
    pb = ft.rff_features(b, f, rt.TransformPipeline(), k, draws=draws)
    got = torch.autograd.grad((pa @ pb.T).sum(), (a, b, s), allow_unused=True)
    close(got[0], want[0], rtol)
    close(got[1], want[1], rtol)
    if kern == "rbf":
        close(got[2], want[2], rtol)


# ---------------------------------------------------------------------------
# Nyström against JAX, fed the JAX pool
# ---------------------------------------------------------------------------

def test_pivoted_cholesky_matches_jax():
    A = np.random.default_rng(9).normal(size=(7, 5))
    G = A @ A.T
    with jax.enable_x64(True):
        jpiv, jres = jft.pivoted_cholesky(jnp.asarray(G), 4)
    piv, res = ft.pivoted_cholesky(t(G), 4)
    assert piv.tolist() == np.asarray(jpiv).tolist()
    close(res, jres, 1e-10)
    with pytest.raises(ValueError, match="rank"):
        ft.pivoted_cholesky(t(G), 8)


def test_nystroem_factor_and_phi_match_jax():
    A = np.random.default_rng(10).normal(size=(5, 6))
    W, K = A @ A.T, np.random.default_rng(11).normal(size=(8, 5))
    with jax.enable_x64(True):
        jL = jft.nystroem_factor(jnp.asarray(W), 1e-6)
        want = jft.nystroem_phi(jnp.asarray(K), jL)
    Lw = ft.nystroem_factor(t(W), 1e-6)
    close(Lw, jL, 1e-10)
    close(ft.nystroem_phi(t(K), Lw), want, 1e-10)


def _nystroem_both(kern, X, Y, rank, dtype, grad):
    """phi(X), phi(Y) (and d Σ phi(X)·phi(Y)ᵀ / dX) from both packages on
    the JAX pool, through the exact "reference" backend."""
    tk, jk = KERNELS[kern]
    f, jf = both_feats("nystroem", rank)
    cfg, jcfg = rt.TransformPipeline(), repro.TransformPipeline()
    g, jg = rt.GridConfig(), repro.GridConfig()
    with jax.enable_x64(dtype == np.float64):
        pool = np.asarray(jax.random.permutation(jf.resolved_key(), X.shape[0]))
        pool = pool[:jf.pool_size(X.shape[0])]

        def jmaps(a):
            sA = jgram._prepare(a, jcfg, jk)
            sB = jgram._prepare(jnp.asarray(Y), jcfg, jk)
            return jgram._nystroem_maps(sA, sB, jf, jk, "reference", jg, repro.LaunchConfig())

        want = jmaps(jnp.asarray(X))
        def jloss(a):
            phi_a, phi_b = jmaps(a)
            return jnp.sum(phi_a @ phi_b.T)

        jgrad = jax.grad(jloss)(jnp.asarray(X)) if grad else None
    a = t(X).clone().requires_grad_()
    got = tgram._nystroem_maps(tgram._prepare(a, cfg, tk), tgram._prepare(t(Y), cfg, tk), f,
                               tk, "reference", g, rt.LaunchConfig(), pool_idx=t(pool))
    tgrad = torch.autograd.grad((got[0] @ got[1].T).sum(), a)[0] if grad else None
    return got, want, tgrad, jgrad


@pytest.mark.parametrize("rank", [2, 5])
@pytest.mark.parametrize("kern", ["linear", "rbf"])
def test_nystroem_maps_match_jax_f64(kern, rank):
    X, Y = paths(12, 6, 6, D), paths(13, 5, 6, D)
    got, want, tgrad, jgrad = _nystroem_both(kern, X, Y, rank, np.float64, grad=True)
    close(got[0], want[0], 1e-10)
    close(got[1], want[1], 1e-10)
    close(tgrad, jgrad, 1e-10)


def test_nystroem_maps_match_jax_f32():
    X, Y = paths(14, 6, L, D, dtype=np.float32), paths(15, 5, L, D, dtype=np.float32)
    got, want, _, _ = _nystroem_both("linear", X, Y, 2, np.float32, grad=False)
    close(got[0] @ got[1].T, want[0] @ want[1].T, 5e-5)


def test_nystroem_sigma_gradient_matches_jax():
    X = paths(16, 6, L, D)
    f, jf = both_feats("nystroem", 3)
    with jax.enable_x64(True):
        pool = np.asarray(jax.random.permutation(jf.resolved_key(), 6))[:jf.pool_size(6)]

        def jloss(s):
            k = repro.RBF(s)
            sX = jgram._prepare(jnp.asarray(X), repro.TransformPipeline(), k)
            phi, _ = jgram._nystroem_maps(sX, None, jf, k, "reference", repro.GridConfig(),
                                          repro.LaunchConfig())
            return jnp.sum(phi @ phi.T)

        want = jax.grad(jloss)(jnp.asarray(0.8))
    s = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    k = rt.RBF(s)
    sX = tgram._prepare(t(X), rt.TransformPipeline(), k)
    phi, _ = tgram._nystroem_maps(sX, None, f, k, "reference", rt.GridConfig(),
                                  rt.LaunchConfig(), pool_idx=t(pool))
    close(torch.autograd.grad((phi @ phi.T).sum(), s)[0], want, 1e-10)


# ---------------------------------------------------------------------------
# the entry points with the port's own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["rff", "nystroem"])
def test_gram_is_the_feature_product(method):
    X, Y = t(paths(17, B, L, D)), t(paths(18, B + 1, L, D))
    f = rt.FeatureConfig(method, rank=3)
    K = rt.sigkernel_gram(X, Y, features=f)
    cfg, g, k = rt.TransformPipeline(), rt.GridConfig(), rt.Linear()
    phiX, phiY = tgram._feature_maps(X, Y, f, cfg, g, k, None, None, rt.LaunchConfig())
    close(K, phiX @ phiY.T, 1e-12)
    Kxx = rt.sigkernel_gram(X, features=f)
    assert Kxx.shape == (B, B)
    close(Kxx, Kxx.T, 1e-12)


def test_feature_seed_reproducibility():
    X, Y = t(paths(19, B, L, D)), t(paths(20, B + 1, L, D))
    K0 = rt.sigkernel_gram(X, Y, features=rt.FeatureConfig("rff", rank=64))
    K0b = rt.sigkernel_gram(X, Y, features=rt.FeatureConfig("rff", rank=64, seed=0))
    K7 = rt.sigkernel_gram(X, Y, features=rt.FeatureConfig("rff", rank=64, seed=7))
    assert torch.equal(K0, K0b)
    assert rel_fro(K7, K0) > 1e-4
    draws = ft.rff_draws(rt.FeatureConfig("rff", rank=64, seed=7), rt.RBF(0.5), D,
                         dtype=torch.float64, device="cpu")
    again = ft.rff_draws(rt.FeatureConfig("rff", rank=64, seed=7), rt.RBF(0.5), D,
                         dtype=torch.float64, device="cpu")
    other = ft.rff_draws(rt.FeatureConfig("rff", rank=64, seed=8), rt.RBF(0.5), D,
                         dtype=torch.float64, device="cpu")
    for a, b, c in zip((draws.w, draws.b, draws.proj), (again.w, again.b, again.proj),
                       (other.w, other.b, other.proj)):
        assert torch.equal(a, b) and not torch.equal(a, c)
    pool = [ft.nystroem_pool(rt.FeatureConfig("nystroem", rank=2, seed=s), 12, device="cpu")
            for s in (0, 0, 1)]
    assert torch.equal(pool[0], pool[1]) and not torch.equal(pool[0], pool[2])


def test_rff_gram_approximates_exact():
    X, Y = t(paths(0, B, L, D)), t(paths(1, B + 1, L, D))
    Ke = rt.sigkernel_gram(X, Y)
    f = rt.FeatureConfig("rff", rank=256)
    assert rel_fro(rt.sigkernel_gram(X, Y, features=f), Ke) < 0.1
    kern = rt.RBF(1.0)
    Ke = rt.sigkernel_gram(X, Y, static_kernel=kern)
    Ka = rt.sigkernel_gram(X, Y, static_kernel=kern,
                           features=rt.FeatureConfig("rff", rank=256, lift_dim=128))
    assert rel_fro(Ka, Ke) < 0.15


def test_nystroem_full_rank_reproduces_exact():
    X, Y = t(paths(0, B, L, D)), t(paths(1, B + 1, L, D))
    f = rt.FeatureConfig("nystroem", rank=B + 1)
    assert rel_fro(rt.sigkernel_gram(X, Y, features=f), rt.sigkernel_gram(X, Y)) < 1e-3
    a = X.clone().requires_grad_()
    ga = torch.autograd.grad(rt.sigkernel_gram(a, Y, features=f).sum(), a)[0]
    ge = torch.autograd.grad(rt.sigkernel_gram(a, Y).sum(), a)[0]
    assert rel_fro(ga, ge) < 1e-3


def test_rff_sigma_is_differentiable():
    X, Y = t(paths(0, B, L, D)), t(paths(1, B + 1, L, D))
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    K = rt.sigkernel_gram(X, Y, static_kernel=rt.RBF(s), features=rt.FeatureConfig(rank=64))
    (g,) = torch.autograd.grad(K.sum(), s)
    assert math.isfinite(float(g)) and float(g) != 0.0


def test_ragged_lengths_through_features():
    X, Y = t(paths(0, B, L, D)), t(paths(1, B + 1, L, D))
    lx, ly = torch.tensor([5, 7, 7, 6]), torch.tensor([9, 4, 8, 6, 7])
    f = rt.FeatureConfig("rff", rank=256)
    Ke = rt.sigkernel_gram(X, Y, lengths=lx, lengths_y=ly)
    Ka = rt.sigkernel_gram(X, Y, lengths=lx, lengths_y=ly, features=f)
    assert rel_fro(Ka, Ke) < 0.15
    Xp = X.clone()
    Xp[:, -2:, :] = float("nan")        # padding content must be invisible
    assert torch.equal(rt.sigkernel_gram(Xp, Y, lengths=lx, lengths_y=ly, features=f), Ka)


def test_rff_issues_zero_pde_solves():
    with dispatch.count_pair_solves() as c:
        rt.sigkernel_gram(t(paths(0, B, L, D)), t(paths(1, B + 1, L, D)),
                          features=rt.FeatureConfig("rff", rank=32))
    assert c.total == 0


def test_nystroem_solve_budget_is_pool_plus_rows():
    f = rt.FeatureConfig("nystroem", rank=2)     # pool = 4·rank = 8
    with dispatch.count_pair_solves() as c:
        rt.sigkernel_gram(t(paths(2, 12, 8, 2)), t(paths(3, 10, 8, 2)), features=f)
    assert c.total == 8 * 8 + 12 * 2 + 10 * 2


@pytest.mark.parametrize("method", ["rff", "nystroem"])
def test_reduce_matches_dense_feature_gram(method):
    X, Y = t(paths(21, 6, L, D)), t(paths(22, 5, L, D))
    f = rt.FeatureConfig(method, rank=3)
    K = rt.sigkernel_gram(X, features=f)
    close(rt.sigkernel_gram_reduce(X, features=f), K.sum(), 1e-12)
    close(rt.sigkernel_gram_reduce(X, features=f, include_diag=False),
          K.sum() - torch.trace(K), 1e-12)
    close(rt.sigkernel_gram_reduce(X, Y, features=f),
          rt.sigkernel_gram(X, Y, features=f).sum(), 1e-12)


@pytest.mark.parametrize("method", ["rff", "nystroem"])
def test_mmd2_and_scoring_rule_through_features(method):
    X, Y = t(paths(5, 12, 8, 2)), t(paths(6, 11, 8, 2))
    f = rt.FeatureConfig(method, rank=4)
    v = rt.mmd2(X, Y, features=f)              # streams by default
    close(v, rt.mmd2(X, Y, features=f, streaming=False), 1e-10)
    a = X.clone().requires_grad_()
    (g,) = torch.autograd.grad(rt.mmd2(a, Y, features=f), a)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    sr = rt.scoring_rule(X, Y[0], features=f)
    close(sr, rt.scoring_rule(X, Y[0], features=f, streaming=False), 1e-10)
    sk = rt.SigKernel(features=f, device="cpu")
    close(sk.gram(X, Y), rt.sigkernel_gram(X, Y, features=f), 1e-12)
    close(sk.mmd2(X, Y), v, 1e-12)
    close(sk.scoring_rule(X, Y[0]), sr, 1e-12)
    close(sk(X[:2], Y[:2]), rt.sigkernel(X[:2], Y[:2]), 1e-12)   # forward stays exact


# ---------------------------------------------------------------------------
# sig_aux_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol,grtol", [(np.float64, 1e-10, 1e-10),
                                              (np.float32, 5e-5, 2e-5)], ids=["f64", "f32"])
def test_sig_aux_loss_matches_jax(dtype, rtol, grtol):
    H, T = paths(7, 4, 6, 6, dtype=dtype), paths(8, 5, 6, 2, dtype=dtype)
    P = (np.random.default_rng(9).normal(size=(6, 2)) * 0.3).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        def jloss(h, p):
            return jlosses.sig_aux_loss(h, jnp.asarray(T), proj=p)
        want = jloss(jnp.asarray(H), jnp.asarray(P))
        jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(H), jnp.asarray(P))
    h, p = t(H).clone().requires_grad_(), t(P).clone().requires_grad_()
    got = tlosses.sig_aux_loss(h, t(T), proj=p)
    close(got, want, rtol)
    tg = torch.autograd.grad(got, (h, p))
    close(tg[0], jg[0], grtol)
    close(tg[1], jg[1], grtol)


def test_sig_aux_loss_ragged_matches_jax():
    H, T = paths(10, 4, 8, 6), paths(11, 3, 7, 2)
    P = np.random.default_rng(12).normal(size=(6, 2)) * 0.3
    lh, lt = np.array([8, 5, 6, 3]), np.array([7, 4, 6])
    with jax.enable_x64(True):
        want = jlosses.sig_aux_loss(jnp.asarray(H), jnp.asarray(T), proj=jnp.asarray(P),
                                    lengths=jnp.asarray(lh), lengths_target=jnp.asarray(lt))
    got = tlosses.sig_aux_loss(t(H), t(T), proj=t(P), lengths=t(lh), lengths_target=t(lt))
    close(got, want, 1e-10)


@pytest.mark.parametrize("method", ["rff", "nystroem"])
def test_sig_aux_loss_features_passthrough(method):
    H, T = t(paths(7, 4, 8, 6)), t(paths(8, 4, 8, 2))
    P = t(np.random.default_rng(9).normal(size=(6, 2)) * 0.3)
    f = rt.FeatureConfig(method, rank=3)
    v = tlosses.sig_aux_loss(H, T, proj=P, features=f)
    close(v, rt.mmd2(H @ P / math.sqrt(6), T, unbiased=False, features=f), 1e-12)
