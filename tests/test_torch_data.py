"""The port's synthetic data against the JAX package's, on the CPU.

``jax.random`` and ``torch.Generator`` never draw the same numbers, so the
samplers' pure parts (``_gbm_from_normals``, ``_fbm_from_uniforms``,
``_tokens_from_uniforms``) take the JAX package's own draws, made from its
key as ``repro.data.synthetic`` makes them, and agree with its samplers
within 1e-6.  The port's own draws are held to what they promise: one
``(seed, step)`` gives one batch, on any restart, and another step another;
shapes, dtypes and ranges are the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import PathData, TokenLM, fbm_paths, gbm_paths, step_generator
from repro_torch.data import synthetic as syn

TOL = 1e-6


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("batch,length,dim,mu,sigma", [(4, 10, 3, 0.0, 0.2), (2, 32, 4, 0.05, 0.5),
                                                       (3, 2, 1, 0.0, 0.2)])
def test_gbm_paths_fed_jax_draws(batch, length, dim, mu, sigma):
    key = jax.random.PRNGKey(5)
    z = jax.random.normal(key, (batch, length - 1, dim))   # the draw gbm_paths makes
    want = jsyn.gbm_paths(key, batch, length, dim, mu, sigma)
    got = syn._gbm_from_normals(t(z), mu, sigma)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("hurst,n_modes", [(0.7, 32), (0.3, 8)])
def test_fbm_paths_fed_jax_draws(hurst, n_modes):
    key = jax.random.PRNGKey(6)
    u = jax.random.uniform(key, (3, n_modes, 2))
    want = jsyn.fbm_paths(key, 3, 17, 2, hurst, n_modes)
    assert rel(syn._fbm_from_uniforms(t(u), 17, hurst), want) <= TOL


@pytest.mark.parametrize("vocab", [37, 256, 102400])
def test_tokens_fed_jax_draws(vocab):
    """TokenLM's tokens and labels from JAX's uniforms.  The float32 product
    u³·vocab is truncated to an integer, so a last-bit difference in the
    cube can move a token by one where the product lies within a rounding
    of an integer; every token that differs must sit there."""
    d = jsyn.TokenLM(vocab=vocab, seq=64, batch=8, seed=3)
    key = jax.random.fold_in(jax.random.PRNGKey(d.seed), 2)
    k1 = jax.random.split(key, 4)[0]
    u = jax.random.uniform(k1, (d.batch, d.seq + 1), minval=1e-6, maxval=1.0)
    want = d.batch_at(2)
    got = syn._tokens_from_uniforms(t(u), vocab)
    prod = (np.asarray(u, np.float64) ** 3) * vocab
    near_integer = np.abs(prod - np.round(prod)) <= 4 * np.spacing(np.float32(vocab))
    for name in ("tokens", "labels"):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == np.int64
        cols = slice(0, -1) if name == "tokens" else slice(1, None)
        diff = g != w
        assert np.all(np.abs(g - w)[diff] == 1)
        assert np.all(near_integer[:, cols][diff])
        assert diff.mean() <= 1e-3


def test_step_generator_is_a_function_of_seed_and_step():
    draw = lambda s, k: torch.rand(8, generator=step_generator(s, k, "cpu"))
    assert torch.equal(draw(1, 2), draw(1, 2))
    assert not torch.equal(draw(1, 2), draw(1, 3))
    assert not torch.equal(draw(1, 2), draw(2, 2))
    assert not torch.equal(draw(0, 1), draw(1, 0))


def test_deterministic_and_step_indexed():
    d = TokenLM(vocab=100, seq=16, batch=4, seed=7, device="cpu")
    b1, b2, b3 = d.batch_at(12), d.batch_at(12), d.batch_at(13)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_resume_exactness():
    """Restarting at step k yields the identical stream: no pipeline state."""
    d = TokenLM(vocab=100, seq=8, batch=2, seed=1, device="cpu")
    first = [d.batch_at(s)["tokens"] for s in range(10)]
    d2 = TokenLM(vocab=100, seq=8, batch=2, seed=1, device="cpu")   # a restarted process
    for a, b in zip(first[5:], [d2.batch_at(s)["tokens"] for s in range(5, 10)]):
        assert torch.equal(a, b)


def test_token_batch_contract():
    d = TokenLM(vocab=37, seq=64, batch=8, seed=3, n_patches=4, n_frames=5, d_model=16,
                sig_target_dim=4, device="cpu")
    b = d.batch_at(2)
    jb = jsyn.TokenLM(vocab=37, seq=64, batch=8, seed=3, n_patches=4, n_frames=5,
                      d_model=16, sig_target_dim=4).batch_at(2)
    assert set(b) == set(jb)
    for k in b:
        assert tuple(b[k].shape) == tuple(jb[k].shape), k
    assert b["patches"].dtype == b["frames"].dtype == torch.bfloat16
    assert b["sig_target"].dtype == torch.float32
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 37
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert torch.equal(b["sig_target"][:, 0], torch.zeros(8, 4))


def test_gbm_and_fbm_samplers():
    g = step_generator(0, 0, "cpu")
    p = gbm_paths(g, 4, 10, 3)
    assert p.shape == (4, 10, 3) and torch.isfinite(p).all()
    assert torch.equal(p[:, 0], torch.zeros(4, 3))
    f = fbm_paths(g, 2, 11, 3)
    assert f.shape == (2, 11, 3) and torch.isfinite(f).all()


def test_path_data():
    d = PathData(batch=3, length=12, dim=2, seed=5, device="cpu")
    p1, p2 = d.batch_at(4), d.batch_at(4)
    assert torch.equal(p1, p2) and p1.shape == (3, 12, 2)
    assert not torch.equal(p1, d.batch_at(5))
    with pytest.raises(ValueError, match="GBM paths only"):
        PathData(batch=3, length=12, dim=2, kind="fbm", device="cpu").batch_at(0)


def test_data_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenLM(vocab=10, seq=4, batch=2).batch_at(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PathData(batch=2, length=4, dim=2).batch_at(0)
