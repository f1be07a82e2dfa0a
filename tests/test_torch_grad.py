"""The port's exact signature-kernel gradient against the JAX package's.

The same seeded numpy inputs go through ``jax.grad`` of the JAX package and
``torch.autograd`` of the port, on the CPU.  The JAX side is always its
``reference``/``antidiag`` custom VJP (``solve_goursat_grad``), never its
Pallas backward, which does not run on the installed JAX (ROADMAP C1).  The
port's side covers every route: the row-scan oracle (``reference``), the
vectorised wavefronts (``antidiag``, and the plain versions of the CUDA
kernels that ``ops.py`` takes for CPU tensors).

Tolerances are the JAX suite's own (``tests/test_schemes.py:124``): float64
1e-10, float32 2e-5, bf16 interiors 2e-4 — relative to the largest entry of
the JAX gradient.
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
from repro.core.config import LaunchConfig as JaxLaunch
from repro.kernels.sigkernel_pde import ops as jops
from repro.kernels.sigkernel_pde import stencil as jstencil
from repro_torch.kernels.sigkernel_pde import kernel, ops, stencil

jsk = importlib.import_module("repro.core.sigkernel")
tsk = importlib.import_module("repro_torch.core.sigkernel")

TOL = {"float64": 1e-10, "float32": 2e-5, "bfloat16": 2e-4}
LAMS = [(0, 0), (1, 1), (1, 0)]
COMBOS = [(s, i, lam) for s in ("order1", "order2") for i in ("float32", "bfloat16")
          for lam in LAMS]
IDS = [f"{s}-{i}-lam{l1}{l2}" for s, i, (l1, l2) in COMBOS]


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def _rng(seed):
    return np.random.default_rng(seed)


def _delta(seed, B=2, Lx=5, Ly=4, dtype=np.float64):
    return (_rng(seed).normal(size=(B, Lx, Ly)) * 0.4).astype(dtype)


def paths(seed, B, L, d=2, dtype=np.float64):
    steps = _rng(seed).normal(size=(B, L, d)) * 0.4
    return np.cumsum(steps, axis=1).astype(dtype)


def _grid(jgrid):
    """The port's GridConfig from the JAX package's."""
    return rt.GridConfig(jgrid.lam1, jgrid.lam2, jgrid.scheme, jgrid.interior_dtype)


# ---------------------------------------------------------------------------
# stencil derivatives and the straight-through rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["coeff_dA", "coeff_dB1", "coeff_dB2", "coeff_dC2"])
def test_stencil_derivatives_match_jax(name):
    p = _rng(0).normal(size=(3, 7))
    with jax.enable_x64(True):
        want = np.asarray(getattr(jstencil, name)(jnp.asarray(p)))
    close(getattr(stencil, name)(torch.from_numpy(p)), want, 1e-15)


@pytest.mark.parametrize("name", ["coeff_dB2_at", "coeff_dC2_at"])
def test_gridline_derivatives_match_jax(name):
    p = _rng(1).normal(size=(4, 6))
    edge = _rng(2).random(size=(4, 6)) < 0.5
    with jax.enable_x64(True):
        want = np.asarray(getattr(jstencil, name)(jnp.asarray(p), jnp.asarray(edge)))
    # the port divides by 6 as a multiplication by the reciprocal: 1 ulp
    close(getattr(stencil, name)(torch.from_numpy(p), torch.from_numpy(edge)), want, 1e-15)


@pytest.mark.parametrize("scheme", ["order1", "order2"])
def test_scheme_dispatched_derivative_matches_jax(scheme):
    p = _rng(3).normal(size=(5,))
    with jax.enable_x64(True):
        want = np.asarray(jstencil.coeff_dB(jnp.asarray(p), scheme))
    close(stencil.coeff_dB(torch.from_numpy(p), scheme), want, 1e-15)


def test_round_interior_gradient_is_the_identity():
    x = torch.linspace(-3.0, 3.0, 101, dtype=torch.float32).requires_grad_()
    ct = torch.from_numpy(_rng(4).normal(size=101).astype(np.float32))
    y = stencil.round_interior(x, "bfloat16")
    assert not torch.equal(y, x)                         # it does round
    (g,) = torch.autograd.grad(y, x, ct)
    torch.testing.assert_close(g, ct, rtol=0, atol=0)    # the cotangent is not


@pytest.mark.parametrize("scheme", ["order1", "order2"])
def test_bf16_interior_autograd_matches_jax(scheme):
    """Autograd straight through the row-scan forward with bf16 interiors
    (the straight-through rounding) against ``jax.grad`` of the JAX one."""
    d = _delta(5, dtype=np.float32)

    def jf(a):
        return jsk.solve_goursat(a, 1, 1, scheme=scheme, interior_dtype="bfloat16").sum()

    want = np.asarray(jax.grad(jf)(jnp.asarray(d)))
    dt = torch.from_numpy(d).requires_grad_()
    tsk.solve_goursat(dt, 1, 1, scheme=scheme, interior_dtype="bfloat16").sum().backward()
    close(dt.grad, want, TOL["bfloat16"])


# ---------------------------------------------------------------------------
# the exact adjoint: row-scan oracle and the vectorised reverse wavefront
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme, idt, lam", COMBOS, ids=IDS)
def test_solve_goursat_grad_matches_jax(scheme, idt, lam):
    d, g = _delta(6), _rng(7).normal(size=2)
    with jax.enable_x64(True):
        dj = jnp.asarray(d)
        grid = jsk.solve_goursat(dj, *lam, return_grid=True, scheme=scheme,
                                 interior_dtype=idt)
        want = np.asarray(jsk.solve_goursat_grad(dj, grid, jnp.asarray(g), *lam,
                                                 scheme=scheme, interior_dtype=idt))
    dt, gt = torch.from_numpy(d), torch.from_numpy(g)
    tgrid = tsk.solve_goursat(dt, *lam, return_grid=True, scheme=scheme, interior_dtype=idt)
    close(tsk.solve_goursat_grad(dt, tgrid, gt, *lam, scheme, idt), want, TOL["float64"])
    # the plain version of the backward kernel, over 2- and 4-row strips
    for T in (2, 4):
        k, cps = kernel.solve_with_grid_plain(dt, T, *lam, scheme, idt)
        close(k, np.asarray(grid)[:, -1, -1], TOL["float64"])
        close(kernel.solve_grad_plain(dt, cps, gt, T, *lam, scheme, idt), want,
              TOL["float64"])


@pytest.mark.parametrize("scheme, idt", [("order1", "float32"), ("order2", "bfloat16")])
def test_solve_grad_plain_float32_matches_jax(scheme, idt):
    d, g = _delta(8, B=3, Lx=7, Ly=6, dtype=np.float32), _rng(9).normal(size=3)
    dj = jnp.asarray(d)
    grid = jsk.solve_goursat(dj, 1, 1, return_grid=True, scheme=scheme, interior_dtype=idt)
    want = np.asarray(jsk.solve_goursat_grad(dj, grid, jnp.asarray(g, jnp.float32), 1, 1,
                                             scheme=scheme, interior_dtype=idt))
    dt = torch.from_numpy(d)
    _, cps = kernel.solve_with_grid_plain(dt, 4, 1, 1, scheme, idt)
    got = kernel.solve_grad_plain(dt, cps, torch.from_numpy(g).float(), 4, 1, 1, scheme, idt)
    assert got.dtype == torch.float32
    close(got, want, TOL[idt])


@pytest.mark.parametrize("scheme", ["order1", "order2"])
def test_checkpoint_rows_match_pallas_save_cps(scheme):
    """The plain checkpoint forward writes the JAX kernel's save_cps rows
    (Pallas interpret mode; Lx = 7 pads to the 2-row strips of T = 4)."""
    d = _delta(10, B=2, Lx=7, Ly=5, dtype=np.float32)
    want_k, want_cps = jops.solve_with_grid(jnp.asarray(d), 1, 1, JaxLaunch(pde_strip=4),
                                            scheme=scheme)
    k, cps = kernel.solve_with_grid_plain(torch.from_numpy(d), 4, 1, 1, scheme, "float32")
    assert cps.shape == want_cps.shape
    close(k, want_k, 5e-5)
    close(cps, want_cps, 5e-5)


# ---------------------------------------------------------------------------
# autograd through the solver routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "antidiag", "gpu"])
@pytest.mark.parametrize("scheme", ["order1", "order2"])
def test_gradcheck_sigkernel_from_delta(backend, scheme):
    """Finite differences in float64.  ``"gpu"`` calls the kernels' wrapper
    (``ops.solve``) directly, which takes the plain versions on the CPU."""
    g = rt.GridConfig(1, 1, scheme)
    delta = torch.from_numpy(_delta(11, B=2, Lx=3, Ly=3)).requires_grad_()
    if backend == "gpu":
        def fn(d):
            return ops.solve(d, 1, 1, rt.LaunchConfig(pde_strip=2), scheme)
    else:
        def fn(d):
            return tsk._sigkernel_from_delta(d, g, backend)
    assert torch.autograd.gradcheck(fn, (delta,), eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("scheme, idt", [("order1", "float32"), ("order1", "bfloat16"),
                                         ("order2", "float32"), ("order2", "bfloat16")])
def test_ops_solve_grad_matches_jax(scheme, idt):
    """``ops.solve`` on CPU float32 tensors: the checkpoint forward and the
    backward's plain versions over 4-row strips, against JAX's reference."""
    d, g = _delta(12, B=3, Lx=6, Ly=5, dtype=np.float32), _rng(13).normal(size=3)
    w = jnp.asarray(g, jnp.float32)

    def jf(a):
        return (jsk._sigkernel_from_delta(a, 1, 1, "reference", None, scheme, idt) * w).sum()

    want = np.asarray(jax.grad(jf)(jnp.asarray(d)))
    dt = torch.from_numpy(d).requires_grad_()
    k = ops.solve(dt, 1, 1, rt.LaunchConfig(pde_strip=4), scheme, idt)
    (k * torch.from_numpy(g).float()).sum().backward()
    close(dt.grad, want, TOL[idt])


@pytest.mark.parametrize("which", ["solve_fused", "gram_fused"])
def test_fused_wrappers_grad_match_jax(which):
    """The fused wrappers' backward rebuilds Δ, runs the checkpoint forward
    and the backward, and pulls back with einsum (float64 on the CPU)."""
    dx, dy = _rng(14).normal(size=(3, 6, 2)) * 0.3, _rng(15).normal(size=(3, 5, 2)) * 0.3
    spec = "bid,bjd->bij" if which == "solve_fused" else "aid,bjd->abij"
    w = _rng(16).normal(size=(3,) if which == "solve_fused" else (3, 3))
    with jax.enable_x64(True):
        def jf(a, b):
            k = jsk._sigkernel_from_delta(jnp.einsum(spec, a, b), 1, 0, "reference",
                                          None, "order2", "float32")
            return (k * jnp.asarray(w)).sum()
        want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(dx), jnp.asarray(dy))
    tx, ty = torch.from_numpy(dx).requires_grad_(), torch.from_numpy(dy).requires_grad_()
    k = getattr(ops, which)(tx, ty, 1, 0, None, "order2")
    (k * torch.from_numpy(w)).sum().backward()
    close(tx.grad, want[0], TOL["float64"])
    close(ty.grad, want[1], TOL["float64"])


#: (name, JAX config kwargs) for the entry-point gradients
CONFIGS = {
    "linear": dict(),
    "order2_lam11": dict(grid=repro.GridConfig(1, 1, scheme="order2")),
    "transforms": dict(transforms=repro.TransformPipeline(
        time_aug=True, lead_lag=True, basepoint=True, t0=0.25, t1=2.0)),
    "rbf": dict(static_kernel=repro.RBF(0.8), grid=repro.GridConfig(0, 1)),
    "linear_scaled": dict(static_kernel=repro.Linear(0.5)),
}


def _port_kw(jkw):
    out = {}
    if "grid" in jkw:
        out["grid"] = _grid(jkw["grid"])
    if "transforms" in jkw:
        t = jkw["transforms"]
        out["transforms"] = rt.TransformPipeline(t.time_aug, t.lead_lag, t.basepoint,
                                                 float(t.t0), float(t.t1))
    if "static_kernel" in jkw:
        sk = jkw["static_kernel"]
        out["static_kernel"] = (rt.RBF(float(sk.sigma)) if isinstance(sk, repro.RBF)
                                else rt.Linear(float(sk.scale)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_sigkernel_grads(name):
    """JAX's gradients of Σ w·k(x, y) for one config (its reference and
    antidiag backwards are the same row-scan adjoint)."""
    jkw = CONFIGS[name]
    x, y, w = paths(17, 3, 6), paths(18, 3, 5), _rng(19).normal(size=3)
    with jax.enable_x64(True):
        def jf(a, b):
            return (jsk.sigkernel(a, b, backend="reference", **jkw) * jnp.asarray(w)).sum()
        want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    return x, y, w, [np.asarray(g) for g in want]


@pytest.mark.parametrize("backend", ["reference", "antidiag"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sigkernel_grad_matches_jax(name, backend):
    jkw = CONFIGS[name]
    x, y, w, want = _jax_sigkernel_grads(name)
    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    k = rt.sigkernel(tx, ty, backend=backend, **_port_kw(jkw))
    (k * torch.from_numpy(w)).sum().backward()
    close(tx.grad, want[0], TOL["float64"])
    close(ty.grad, want[1], TOL["float64"])


@pytest.mark.parametrize("name", ["transforms", "rbf"])
def test_sigkernel_ragged_grad_matches_jax(name):
    """pad_ragged, the end-aligned streams and (rbf) transform_path with the
    Δ-from-Gram route carry the gradient."""
    x, y = paths(20, 3, 6), paths(21, 3, 8)
    lx, ly = np.array([6, 3, 5]), np.array([8, 2, 6])
    jkw = CONFIGS[name]
    with jax.enable_x64(True):
        def jf(a, b):
            return jsk.sigkernel(a, b, lengths_x=lx, lengths_y=ly, **jkw).sum()
        want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    rt.sigkernel(tx, ty, lengths_x=lx, lengths_y=ly, **_port_kw(jkw)).sum().backward()
    close(tx.grad, want[0], TOL["float64"])
    close(ty.grad, want[1], TOL["float64"])


@pytest.mark.parametrize("idt", ["float32", "bfloat16"])
def test_sigkernel_float32_grad_matches_jax(idt):
    """float32 paths through the anti-diagonal route on both sides."""
    x, y = paths(22, 3, 8, 3, np.float32) / 2, paths(23, 3, 7, 3, np.float32) / 2
    jgrid = repro.GridConfig(1, 1, scheme="order2", interior_dtype=idt)

    def jf(a, b):   # JAX's antidiag backward is its row-scan adjoint too
        return jsk.sigkernel(a, b, grid=jgrid, backend="reference").sum()

    want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    rt.sigkernel(tx, ty, grid=_grid(jgrid), backend="antidiag").sum().backward()
    assert tx.grad.dtype == torch.float32
    close(tx.grad, want[0], TOL[idt])
    close(ty.grad, want[1], TOL[idt])


def test_sigkernel_module_is_differentiable():
    """SigKernel's forward, gram and mmd2 give the functional API's gradients
    (which the tests above and test_torch_reduce.py hold against JAX)."""
    X, Y = torch.from_numpy(paths(24, 3, 6)), torch.from_numpy(paths(25, 2, 7))
    kw = _port_kw(CONFIGS["rbf"])
    tmod = rt.SigKernel(device="cpu", **kw)
    W = torch.from_numpy(_rng(26).normal(size=(3, 2)))
    calls = [(lambda a: tmod(a[:2], Y).sum(), lambda a: rt.sigkernel(a[:2], Y, **kw).sum()),
             (lambda a: (tmod.gram(a, Y) * W).sum(),
              lambda a: (rt.sigkernel_gram(a, Y, **kw) * W).sum()),
             (lambda a: tmod.mmd2(a, Y), lambda a: rt.mmd2(a, Y, **kw))]
    for via_module, via_function in calls:
        Xm, Xf = X.clone().requires_grad_(), X.clone().requires_grad_()
        (g_mod,) = torch.autograd.grad(via_module(Xm), Xm)
        (g_fun,) = torch.autograd.grad(via_function(Xf), Xf)
        torch.testing.assert_close(g_mod, g_fun, rtol=0, atol=0)
