"""The port's signature-kernel forward path against the JAX package's.

``sigkernel``, ``sigkernel_gram`` (dense, row-blocked, symmetric), ``mmd2``,
``scoring_rule`` and ``SigKernel`` run on the CPU (the plain solvers) on the
same numpy inputs as the JAX entry points, with the configs carried across
by :func:`repro_torch.configs_from_reference`.  Most cases run in float64
(``jax.enable_x64`` as a context manager, so the flag does not leak into
other test files), where the two packages do the same arithmetic and agree
to rtol 1e-10; float32 cases hold to 5e-5.  The guard tests pin the port's
contract: no JAX in the port or in chip_smoke.py, the CUDA backends refuse
CPU tensors, and CPU calls (gradients included) never count a kernel
launch.  The gradients themselves are held against JAX in
``test_torch_grad.py`` and ``test_torch_reduce.py``.
"""

import ast
import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro_torch.core import dispatch
from repro_torch.kernels.sigkernel_pde import kernel, ops

jsk = importlib.import_module("repro.core.sigkernel")
jgram = importlib.import_module("repro.core.gram")
jlosses = importlib.import_module("repro.core.losses")

ROOT = os.path.join(os.path.dirname(__file__), "..")


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def paths(seed, B, L, d=2, dtype=np.float64):
    steps = np.random.default_rng(seed).normal(size=(B, L, d)) * 0.4
    return np.cumsum(steps, axis=1).astype(dtype)


def as_fields(obj):
    return {k: np.asarray(v) for k, v in dataclasses.asdict(obj).items()}


def carried(transforms=None, grid=None, static_kernel=None):
    """The JAX configs' field values, rebuilt as the port's configs."""
    fields = {}
    if transforms is not None:
        fields["transforms"] = as_fields(transforms)
    if grid is not None:
        fields["grid"] = as_fields(grid)
    if static_kernel is not None:
        fields["static_kernel"] = {"kind": type(static_kernel).__name__,
                                   **as_fields(static_kernel)}
    port = rt.configs_from_reference(fields)
    return {k: port[k] for k in ("transforms", "grid", "static_kernel")}


#: (name, JAX config kwargs): the configurations the slice is checked in
CONFIGS = {
    "linear": dict(),
    "order2_lam11": dict(grid=repro.GridConfig(1, 1, scheme="order2")),
    "transforms": dict(transforms=repro.TransformPipeline(
        time_aug=True, lead_lag=True, basepoint=True, t0=0.25, t1=2.0)),
    "rbf": dict(static_kernel=repro.RBF(0.8), grid=repro.GridConfig(0, 1)),
    "linear_scaled": dict(static_kernel=repro.Linear(0.5)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sigkernel_matches_jax(name):
    jkw = CONFIGS[name]
    x, y = paths(0, 3, 9), paths(1, 3, 7)
    with jax.enable_x64(True):
        want = jsk.sigkernel(jnp.asarray(x), jnp.asarray(y), **jkw)
    got = rt.sigkernel(torch.from_numpy(x), torch.from_numpy(y), **carried(**jkw))
    close(got, want, 1e-10)


def test_sigkernel_ragged_matches_jax():
    x, y = paths(2, 3, 9), paths(3, 3, 12)
    lx, ly = np.array([9, 4, 6]), np.array([12, 2, 7])
    jkw = CONFIGS["transforms"]
    with jax.enable_x64(True):
        want = jsk.sigkernel(jnp.asarray(x), jnp.asarray(y), lengths_x=lx,
                             lengths_y=ly, **jkw)
    got = rt.sigkernel(torch.from_numpy(x), torch.from_numpy(y), lengths_x=lx,
                       lengths_y=ly, **carried(**jkw))
    close(got, want, 1e-10)


def test_sigkernel_float32_matches_jax():
    # 79 x 69 cells: both packages take the anti-diagonal solver
    x, y = paths(4, 4, 80, dtype=np.float32) / 4, paths(5, 4, 70, dtype=np.float32) / 4
    want = jsk.sigkernel(jnp.asarray(x), jnp.asarray(y))
    got = rt.sigkernel(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    close(got, want, 5e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["dense", "row_block", "symmetric"])
def test_gram_matches_jax(name, mode):
    jkw = CONFIGS[name]
    X, Y = paths(6, 3, 8), paths(7, 4, 6)
    kw = {"dense": {}, "row_block": {"row_block": 2}, "symmetric": {}}[mode]
    Yt = None if mode == "symmetric" else torch.from_numpy(Y)
    with jax.enable_x64(True):
        Yj = None if mode == "symmetric" else jnp.asarray(Y)
        want = jgram.sigkernel_gram(jnp.asarray(X), Yj, **kw, **jkw)
    got = rt.sigkernel_gram(torch.from_numpy(X), Yt, **kw, **carried(**jkw))
    close(got, want, 1e-10)


def test_gram_ragged_row_block_matches_jax():
    X, Y = paths(8, 5, 9), paths(9, 3, 7)
    lx, ly = np.array([9, 3, 5, 2, 8]), np.array([7, 4, 2])
    jkw = CONFIGS["rbf"]
    with jax.enable_x64(True):
        want = jgram.sigkernel_gram(jnp.asarray(X), jnp.asarray(Y), lengths=lx,
                                    lengths_y=ly, row_block=2, **jkw)
    got = rt.sigkernel_gram(torch.from_numpy(X), torch.from_numpy(Y), lengths=lx,
                            lengths_y=ly, row_block=2, **carried(**jkw))
    close(got, want, 1e-10)


def test_symmetric_gram_solves_the_upper_triangle():
    X = torch.from_numpy(paths(10, 6, 5))
    with dispatch.count_pair_solves() as c:
        K = rt.sigkernel_gram(X)
    assert c.total == 6 * 7 // 2
    close(K, rt.sigkernel_gram(X, X), 1e-12)
    np.testing.assert_array_equal(K.numpy(), K.numpy().T)


@pytest.mark.parametrize("unbiased", [True, False])
@pytest.mark.parametrize("name", ["linear", "order2_lam11", "rbf"])
def test_mmd2_matches_jax(name, unbiased):
    jkw = CONFIGS[name]
    X, Y = paths(11, 3, 8), paths(12, 4, 6)
    lx = np.array([8, 5, 3])
    with jax.enable_x64(True):
        want = jlosses.mmd2(jnp.asarray(X), jnp.asarray(Y), lengths=lx,
                            unbiased=unbiased, **jkw)
    got = rt.mmd2(torch.from_numpy(X), torch.from_numpy(Y), lengths=lx,
                  unbiased=unbiased, **carried(**jkw))
    close(got, want, 1e-10)


def test_scoring_rule_matches_jax():
    X, y = paths(13, 4, 8), paths(14, 1, 10)[0]
    jkw = CONFIGS["transforms"]
    with jax.enable_x64(True):
        want = jlosses.scoring_rule(jnp.asarray(X), jnp.asarray(y), length_y=7, **jkw)
    got = rt.scoring_rule(torch.from_numpy(X), torch.from_numpy(y), length_y=7,
                          **carried(**jkw))
    close(got, want, 1e-10)


@pytest.mark.parametrize("name", ["linear", "rbf"])
def test_sigkernel_module_matches_jax(name):
    jkw = CONFIGS[name]
    X, Y = paths(15, 3, 8), paths(16, 2, 9)
    jmod = repro.SigKernel(**jkw)
    tmod = rt.SigKernel(device="cpu", **carried(**jkw))
    with jax.enable_x64(True):
        want_g = jmod.gram(jnp.asarray(X), jnp.asarray(Y))
        want_s = jmod.gram(jnp.asarray(X))
        want_m = jmod.mmd2(jnp.asarray(X), jnp.asarray(Y))
        want_k = jmod(jnp.asarray(X[:2]), jnp.asarray(Y))
    close(tmod.gram(X, Y), want_g, 1e-10)
    close(tmod.gram(X), want_s, 1e-10)
    close(tmod.mmd2(X, Y), want_m, 1e-10)
    close(tmod(X[:2], Y), want_k, 1e-10)


# ---------------------------------------------------------------------------
# the slice's contract
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    # every module of the port (the signature modules and the model, data,
    # optimizer, train and serve subpackages included), the script and the
    # port's example scripts
    examples = ["train_sigkernel_gan_torch", "serve_lm_torch", "quickstart_torch",
                "gram_matrix_distributed_torch", "serve_sig_features_torch"]
    prog = ("import importlib, importlib.util, pkgutil, sys, repro_torch, chip_smoke; "
            "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.')]; [importlib.import_module(n) for n in names]; "
            "assert 'repro_torch.kernels.signature.ref' in names, names; "
            "assert 'repro_torch.train.step' in names, names; "
            "assert 'repro_torch.serve.step' in names, names; "
            "assert 'repro_torch.models.rglru' in names, names; "
            "assert 'repro_torch.models.moe' in names, names; "
            f"examples = {examples!r}; "
            "specs = [importlib.util.spec_from_file_location(e, f'examples/{e}.py') "
            "for e in examples]; "
            "[s.loader.exec_module(importlib.util.module_from_spec(s)) for s in specs]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": f"src{os.pathsep}."},
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    # chip_smoke.py imports the port inside main(): none of its imports,
    # wherever they stand, may name JAX or the JAX package
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "repro")], names


@pytest.mark.parametrize("backend", ["gpu", "gpu_fused"])
def test_cuda_backends_refuse_cpu_tensors(backend):
    x = torch.from_numpy(paths(17, 2, 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rt.sigkernel(x, x, backend=backend)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rt.sigkernel_gram(x, x, backend=backend)


def test_auto_resolution_follows_the_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dispatch.resolve("auto", op="sigkernel", device=cuda) == "gpu"
    assert dispatch.resolve("auto", op="gram", device=cuda) == "gpu_fused"
    assert dispatch.resolve("auto", op="gram", device=cuda, allow_fused=False) == "gpu"
    small, big = dispatch._ANTIDIAG_MIN_CELLS - 1, dispatch._ANTIDIAG_MIN_CELLS
    assert dispatch.resolve("auto", op="sigkernel", device=cpu, grid_cells=small) \
        == "reference"
    assert dispatch.resolve("auto", op="gram", device=cpu, grid_cells=big) == "antidiag"


def test_gpu_fused_refuses_the_rbf_lift():
    x = torch.from_numpy(paths(18, 2, 5))
    with pytest.raises(ValueError, match="linear lift"):
        rt.sigkernel_gram(x, x, backend="gpu_fused", static_kernel=rt.RBF(1.0))


def test_cpu_calls_launch_no_kernel():
    kernel.reset_launch_counts()
    X, Y = torch.from_numpy(paths(22, 3, 8)), torch.from_numpy(paths(23, 2, 8))
    rt.sigkernel(X[:2], Y)
    rt.sigkernel_gram(X, Y)
    rt.sigkernel_gram(X)
    rt.mmd2(X, Y)
    ops.solve_fused(X, X)
    Xg = X.clone().requires_grad_()
    rt.mmd2(Xg, Y, row_block=1).backward()
    ops.gram_fused(Xg, Y).sum().backward()
    assert kernel.launch_counts() == {"fwd": 0, "fwd_cps": 0, "fwd_fused": 0,
                                      "gram_fused": 0, "bwd": 0}


def test_sigkernel_module_defaults_to_the_card():
    if torch.cuda.is_available():
        assert rt.SigKernel().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rt.SigKernel()
    assert rt.SigKernel(device="cpu").device.type == "cpu"


def test_kernels_available_reports_the_card():
    from repro_torch import kernels
    if not torch.cuda.is_available():
        assert kernels.available() is False


@pytest.mark.parametrize("field, value", [
    ("lam1", -1), ("lam2", 1.5), ("scheme", "order3"), ("interior_dtype", "float16")])
def test_grid_validation_messages_match_jax(field, value):
    with pytest.raises(ValueError) as jax_err:
        repro.GridConfig(**{field: value})
    with pytest.raises(ValueError) as port_err:
        rt.GridConfig(**{field: value})
    assert str(port_err.value) == str(jax_err.value)


def test_configs_from_reference_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown config keys"):
        rt.configs_from_reference({"weights": {}})
    with pytest.raises(ValueError, match="kind"):
        rt.configs_from_reference({"static_kernel": {"sigma": 1.0}})
