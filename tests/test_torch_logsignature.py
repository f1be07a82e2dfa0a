"""The port's log-signatures and Lyndon tables against the JAX package's.

The Lyndon words, Witt dimensions, flat indices, expansion matrix and
change of basis are numpy in both packages and must be equal.  Values and
gradients go through ``repro`` and ``repro_torch`` on the same numpy
inputs on the CPU: float64 (inside ``jax.enable_x64(True)``) to 1e-10
relative, float32 to 5e-5 for values and 2e-5 for gradients; the JAX
Horner kernel runs in interpret mode at small sizes.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro_torch.kernels.signature import kernel, ops

jlyn = importlib.import_module("repro.core.lyndon")
jlog = importlib.import_module("repro.core.logsignature")
tlyn = importlib.import_module("repro_torch.core.lyndon")
tlog = importlib.import_module("repro_torch.core.logsignature")

MODES = ("lyndon", "brackets", "expand")


def close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def paths(seed, B, L, d=2, dtype=np.float64):
    steps = np.random.default_rng(seed).normal(size=(B, L, d)) * 0.3
    return np.cumsum(steps, axis=1).astype(dtype)


def port_transforms(jt):
    fields = {k: np.asarray(v) for k, v in dataclasses.asdict(jt).items()}
    return rt.configs_from_reference({"transforms": fields})["transforms"]


ALL = repro.TransformPipeline(time_aug=True, lead_lag=True, basepoint=True, t1=3.0)


@pytest.mark.parametrize("d, N", [(1, 5), (2, 6), (3, 4), (4, 3), (5, 2)])
def test_lyndon_tables_equal_jax(d, N):
    assert tlyn.lyndon_words(d, N) == jlyn.lyndon_words(d, N)
    assert tlyn.witt_dims(d, N) == jlyn.witt_dims(d, N)
    assert tlyn.logsig_dim(d, N) == jlyn.logsig_dim(d, N)
    assert [tlyn.bracket_string(w) for w in tlyn.lyndon_words(d, N)] == \
        [jlyn.bracket_string(w) for w in jlyn.lyndon_words(d, N)]
    np.testing.assert_array_equal(tlyn.lyndon_flat_indices(d, N),
                                  jlyn.lyndon_flat_indices(d, N))
    np.testing.assert_array_equal(tlyn.expand_matrix(d, N), jlyn.expand_matrix(d, N))
    for got, want in zip(tlyn._basis_change(d, N), jlyn._basis_change(d, N)):
        np.testing.assert_array_equal(got, want)
    for mode in MODES:
        assert tlog.logsignature_dim(d, N, mode) == jlog.logsignature_dim(d, N, mode)


@pytest.mark.parametrize("mode", ["lyndon", "brackets"])
def test_compress_expand_match_jax(mode):
    d, N = 3, 4
    flat = np.random.default_rng(0).normal(size=(2, tlyn.sig_dim(d, N)))
    coeffs = np.random.default_rng(1).normal(size=(2, tlyn.logsig_dim(d, N)))
    with jax.enable_x64(True):
        want_c = jlyn.compress(jnp.asarray(flat), d, N, mode)
        want_e = jlyn.expand(jnp.asarray(coeffs), d, N, mode)
    close(tlyn.compress(torch.from_numpy(flat), d, N, mode), want_c, 1e-10)
    close(tlyn.expand(torch.from_numpy(coeffs), d, N, mode), want_e, 1e-10)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_logsignature_matches_jax_reference(mode, ragged):
    x = paths(2, 3, 10, 2)
    lengths = np.array([10, 3, 6]) if ragged else None
    with jax.enable_x64(True):
        want = jlog.logsignature(jnp.asarray(x), 3, mode=mode, transforms=ALL,
                                 lengths=lengths, backend="reference")
    got = rt.logsignature(torch.from_numpy(x), 3, mode=mode,
                          transforms=port_transforms(ALL), lengths=lengths)
    close(got, want, 1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_logsignature_matches_jax_pallas(mode):
    """The JAX Horner kernel (interpret mode) and its epilogue, float32."""
    x = paths(3, 2, 30, 3, np.float32)
    want = jlog.logsignature(jnp.asarray(x), 4, mode=mode, backend="pallas")
    close(rt.logsignature(torch.from_numpy(x), 4, mode=mode), want, 5e-5)
    z = torch.from_numpy(np.diff(x, axis=1))
    close(ops.logsignature_from_increments(z, 4, mode), want, 5e-5)


@pytest.mark.parametrize("mode", MODES)
def test_logsignature_stream_matches_jax(mode):
    x = paths(4, 2, 8, 2)
    lengths = np.array([8, 5])
    with jax.enable_x64(True):
        want = jlog.logsignature(jnp.asarray(x), 3, mode=mode, stream=True,
                                 lengths=lengths)
    got = rt.logsignature(torch.from_numpy(x), 3, mode=mode, stream=True, lengths=lengths)
    close(got, want, 1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_logsignature_combine_matches_jax(mode):
    x = paths(5, 2, 12, 3)
    d, N, m = 3, 3, 5
    a, b = x[:, :m], x[:, m - 1:]
    with jax.enable_x64(True):
        la = jlog.logsignature(jnp.asarray(a), N, mode=mode)
        lb = jlog.logsignature(jnp.asarray(b), N, mode=mode)
        want = jlog.logsignature_combine(la, lb, d, N, mode)
    ta_, tb_ = (rt.logsignature(torch.from_numpy(p), N, mode=mode) for p in (a, b))
    got = rt.logsignature_combine(ta_, tb_, d, N, mode)
    close(got, want, 1e-10)
    close(got, rt.logsignature(torch.from_numpy(x), N, mode=mode), 1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", MODES)
def test_logsignature_grad_matches_jax(mode, dtype):
    x = paths(6, 2, 9, 2, getattr(np, dtype))
    lengths = np.array([9, 4])
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jax.grad(lambda p: (jlog.logsignature(
            p, 4, mode=mode, transforms=ALL, lengths=lengths,
            backend="reference") ** 2).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (rt.logsignature(xt, 4, mode=mode, transforms=port_transforms(ALL),
                     lengths=lengths) ** 2).sum().backward()
    close(xt.grad, want, 1e-10 if dtype == "float64" else 2e-5)


def test_kernel_wrapper_logsignature_grad_matches_jax():
    z = (np.random.default_rng(7).normal(size=(2, 6, 3)) * 0.3).astype(np.float32)
    want = np.asarray(jax.grad(lambda q: (jlog.logsignature_from_increments(
        q, 3, "brackets") ** 2).sum())(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_()
    (ops.logsignature_from_increments(zt, 3, "brackets") ** 2).sum().backward()
    close(zt.grad, want, 2e-5)


@pytest.mark.parametrize("mode", MODES)
def test_logsignature_module_matches_jax(mode):
    x = paths(8, 3, 7, 2)
    with jax.enable_x64(True):
        want = repro.LogSignature(3, mode=mode, transforms=ALL)(jnp.asarray(x))
    mod = rt.LogSignature(3, mode=mode, transforms=port_transforms(ALL), device="cpu")
    close(mod(x), want, 1e-10)


def test_logsignature_refusals():
    x = torch.from_numpy(paths(9, 2, 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rt.logsignature(x, 3, backend="gpu")
    with pytest.raises(ValueError, match="stream=True"):
        rt.logsignature(x, 3, stream=True, backend="gpu")
    with pytest.raises(ValueError, match="mode must be one of"):
        rt.logsignature(x, 3, mode="words")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rt.LogSignature(3)
    kernel.reset_launch_counts()
    rt.logsignature(x, 3)
    assert kernel.launch_counts() == {"horner": 0}
