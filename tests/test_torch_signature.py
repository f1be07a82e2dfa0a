"""The port's truncated signatures against the JAX package's.

The same numpy inputs go through ``repro`` and ``repro_torch`` on the CPU.
Float64 cases run inside ``jax.enable_x64(True)`` (the flag does not leak
into other test files) and hold to 1e-10 relative, since both packages do
the same arithmetic; float32 cases hold to 5e-5 for values and 2e-5 for
gradients.  The JAX side runs ``backend="reference"`` (the pure-JAX scan,
whose custom VJP is the §2.4 backward) and, at small sizes (L <= 50,
N <= 4), ``backend="pallas"`` in interpret mode, the Horner kernel itself.
On the port's side a CPU tensor takes the plain scan; the Horner kernel's
plain version (``kernel.horner_plain``) is held against the JAX kernel
wrapper on the JAX kernel tests' small cases.
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
from repro_torch.core import dispatch
from repro_torch.core import tensoralg as tta
from repro_torch.kernels.signature import kernel, ops, ref

jta = importlib.import_module("repro.core.tensoralg")
jsig = importlib.import_module("repro.core.signature")
jops = importlib.import_module("repro.kernels.signature.ops")
tsig = importlib.import_module("repro_torch.core.signature")


def close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def paths(seed, B, L, d=2, dtype=np.float64, scale=0.3):
    steps = np.random.default_rng(seed).normal(size=(B, L, d)) * scale
    return np.cumsum(steps, axis=1).astype(dtype)


def port_transforms(jt):
    """The JAX pipeline's field values, rebuilt as the port's pipeline."""
    fields = {k: np.asarray(v) for k, v in dataclasses.asdict(jt).items()}
    return rt.configs_from_reference({"transforms": fields})["transforms"]


#: the §4 pipelines the slice is checked under
TRANSFORMS = {
    "none": repro.TransformPipeline(),
    "time_aug": repro.TransformPipeline(time_aug=True, t0=0.5, t1=2.0),
    "lead_lag": repro.TransformPipeline(lead_lag=True),
    "basepoint": repro.TransformPipeline(basepoint=True),
    "all": repro.TransformPipeline(time_aug=True, lead_lag=True, basepoint=True),
}


# ---------------------------------------------------------------------------
# the tensor algebra
# ---------------------------------------------------------------------------

def _flat(seed, B, d, N):
    return np.random.default_rng(seed).normal(size=(B, jta.sig_dim(d, N))) * 0.5


TENSORALG = {
    "chen": lambda m, a, b, d, N: m.chen(a, b, d, N),
    "tensor_exp": lambda m, a, b, d, N: m.tensor_exp(a[..., :d], N),
    "tensor_log": lambda m, a, b, d, N: m.tensor_log(a, d, N),
    "sig_inverse": lambda m, a, b, d, N: m.sig_inverse(a, d, N),
    "tensor_exp_full": lambda m, a, b, d, N: m.tensor_exp_full(a, d, N),
    "sig_inner": lambda m, a, b, d, N: m.sig_inner(a, b, d, N),
}


@pytest.mark.parametrize("d, N", [(2, 5), (3, 3)])
@pytest.mark.parametrize("op", sorted(TENSORALG))
def test_tensoralg_matches_jax(op, d, N):
    a, b = _flat(0, 3, d, N), _flat(1, 3, d, N)
    with jax.enable_x64(True):
        want = TENSORALG[op](jta, jnp.asarray(a), jnp.asarray(b), d, N)
    got = TENSORALG[op](tta, torch.from_numpy(a), torch.from_numpy(b), d, N)
    close(got, want, 1e-10)


def test_tensoralg_layout_matches_jax():
    for d, N in [(1, 4), (3, 5), (16, 4)]:
        assert tta.level_sizes(d, N) == jta.level_sizes(d, N)
        assert tta.sig_dim(d, N) == jta.sig_dim(d, N)
        assert tta.level_offsets(d, N) == jta.level_offsets(d, N)
    a = torch.from_numpy(_flat(2, 2, 3, 4))
    assert torch.equal(tta.join_levels(tta.split_levels(a, 3, 4)), a)
    assert torch.equal(tta.identity_like((2,), 3, 4, torch.float64),
                       torch.zeros(2, tta.sig_dim(3, 4), dtype=torch.float64))


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_signature_matches_jax_reference(name):
    x = paths(3, 3, 11, 2)
    with jax.enable_x64(True):
        want = jsig.signature(jnp.asarray(x), 4, transforms=TRANSFORMS[name],
                              backend="reference")
    got = rt.signature(torch.from_numpy(x), 4, transforms=port_transforms(TRANSFORMS[name]))
    close(got, want, 1e-10)


@pytest.mark.parametrize("B, L, d, N, name", [
    (3, 20, 3, 4, "none"), (2, 9, 2, 3, "all"), (4, 50, 2, 2, "lead_lag"),
    (1, 2, 4, 4, "time_aug")])
def test_signature_matches_jax_pallas(B, L, d, N, name):
    """The JAX Horner kernel itself (interpret mode), float32."""
    x = paths(4, B, L, d, np.float32)
    want = jsig.signature(jnp.asarray(x), N, transforms=TRANSFORMS[name], backend="pallas")
    got = rt.signature(torch.from_numpy(x), N,
                       transforms=port_transforms(TRANSFORMS[name]))
    assert got.dtype == torch.float32
    close(got, want, 5e-5)


@pytest.mark.parametrize("B, L, d, N", [(3, 10, 3, 4), (2, 7, 2, 6), (1, 5, 8, 3),
                                        (2, 2, 2, 2)])
def test_horner_plain_matches_jax_kernel(B, L, d, N):
    """The JAX kernel tests' small cases (tests/test_kernels_signature.py)."""
    z = (np.random.default_rng(5).normal(size=(B, L - 1, d)) * 0.3).astype(np.float32)
    want = jops.signature_from_increments(jnp.asarray(z), N)
    close(kernel.horner_plain(torch.from_numpy(z), N), want, 5e-5)
    close(ops.signature_from_increments(torch.from_numpy(z), N), want, 5e-5)


@pytest.mark.parametrize("d, N", [(1, 3), (2, 6), (3, 4), (5, 2)])
def test_horner_plain_matches_direct_oracle(d, N):
    z = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 12, d)) * 0.3)
    close(kernel.horner_plain(z, N), ref.signature_from_increments(z, N), 1e-12)


def test_signature_direct_matches_jax():
    x = paths(7, 2, 9, 3)
    tf = TRANSFORMS["all"]
    with jax.enable_x64(True):
        want = jsig.signature_direct(jnp.asarray(x), 3, transforms=tf)
    close(tsig.signature_direct(torch.from_numpy(x), 3, transforms=port_transforms(tf)),
          want, 1e-10)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("name", ["none", "all"])
def test_signature_ragged_matches_jax(name, backend):
    x = paths(8, 4, 13, 2, np.float32 if backend == "pallas" else np.float64)
    lengths = np.array([13, 2, 7, 10])
    tf = TRANSFORMS[name]
    with jax.enable_x64(backend == "reference"):
        want = jsig.signature(jnp.asarray(x), 3, transforms=tf, lengths=lengths,
                              backend=backend)
    got = rt.signature(torch.from_numpy(x), 3, transforms=port_transforms(tf),
                       lengths=lengths)
    close(got, want, 1e-10 if backend == "reference" else 5e-5)


@pytest.mark.parametrize("ragged", [False, True])
def test_signature_stream_matches_jax(ragged):
    x = paths(9, 3, 10, 2)
    lengths = np.array([10, 4, 7]) if ragged else None
    tf = TRANSFORMS["time_aug"]
    with jax.enable_x64(True):
        want = jsig.signature(jnp.asarray(x), 3, transforms=tf, stream=True,
                              lengths=lengths)
    got = rt.signature(torch.from_numpy(x), 3, transforms=port_transforms(tf),
                       stream=True, lengths=lengths)
    close(got, want, 1e-10)
    if not ragged:   # the last prefix is the whole signature
        close(got[:, -1], rt.signature(torch.from_numpy(x), 3,
                                       transforms=port_transforms(tf)), 1e-12)


def test_signature_combine_matches_jax():
    x = paths(10, 2, 15, 3)
    m = 6
    d, N = 3, 4
    a, b = x[:, :m], x[:, m - 1:]
    with jax.enable_x64(True):
        want = jsig.signature_combine(jsig.signature(jnp.asarray(a), N),
                                      jsig.signature(jnp.asarray(b), N), d, N)
    sa = rt.signature(torch.from_numpy(a), N)
    sb = rt.signature(torch.from_numpy(b), N)
    got = rt.signature_combine(sa, sb, d, N)
    close(got, want, 1e-10)
    close(got, rt.signature(torch.from_numpy(x), N), 1e-10)


# ---------------------------------------------------------------------------
# gradients: against jax.grad through backend="reference" (the §2.4 VJP)
# ---------------------------------------------------------------------------

def _jax_grad(fn, x, x64):
    with jax.enable_x64(x64):
        return np.asarray(jax.grad(lambda p: (fn(p) ** 2).sum())(jnp.asarray(x)))


def _port_grad(fn, x):
    xt = torch.from_numpy(x).requires_grad_()
    (fn(xt) ** 2).sum().backward()
    return xt.grad


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["none", "all"])
def test_signature_grad_matches_jax(name, dtype):
    x = paths(11, 3, 9, 2, getattr(np, dtype))
    tf = TRANSFORMS[name]
    lengths = np.array([9, 3, 6])
    want = _jax_grad(lambda p: jsig.signature(p, 4, transforms=tf, lengths=lengths,
                                              backend="reference"), x, dtype == "float64")
    got = _port_grad(lambda p: rt.signature(p, 4, transforms=port_transforms(tf),
                                            lengths=lengths), x)
    close(got, want, 1e-10 if dtype == "float64" else 2e-5)


def test_kernel_wrapper_grad_matches_jax():
    """The kernel wrapper's autograd Function (plain forward on the CPU,
    §2.4 backward) against JAX's reference gradient, float32."""
    z = (np.random.default_rng(12).normal(size=(2, 8, 3)) * 0.3).astype(np.float32)
    want = _jax_grad(lambda q: jsig._signature_core(q, 3), z, False)
    got = _port_grad(lambda q: ops.signature_from_increments(q, 3), z)
    close(got, want, 2e-5)


def test_signature_stream_grad_matches_jax():
    x = paths(13, 2, 7, 2)
    want = _jax_grad(lambda p: jsig.signature(p, 3, stream=True), x, True)
    got = _port_grad(lambda p: rt.signature(p, 3, stream=True), x)
    close(got, want, 1e-10)


def test_backward_holds_no_per_step_signature():
    """The §2.4 backward's saved tensors are the increments and the final
    signature only, whatever the path length."""
    for L in (5, 40):
        x = torch.from_numpy(paths(14, 2, L, 2)).requires_grad_()
        out = rt.signature(x, 3)
        saved = [t for t in (out.grad_fn.saved_tensors or ())]
        assert sorted(tuple(t.shape) for t in saved) == sorted([(2, L - 1, 2), (2, 14)])


# ---------------------------------------------------------------------------
# modules, dispatch and launch settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True])
def test_signature_module_matches_jax(stream):
    x = paths(15, 3, 8, 2)
    lengths = np.array([8, 5, 3])
    tf = TRANSFORMS["lead_lag"]
    with jax.enable_x64(True):
        want = repro.Signature(3, transforms=tf, stream=stream)(jnp.asarray(x),
                                                                lengths=lengths)
    mod = rt.Signature(3, transforms=port_transforms(tf), stream=stream, device="cpu")
    close(mod(x, lengths=lengths), want, 1e-10)


def test_signature_module_defaults_to_the_card():
    if torch.cuda.is_available():
        assert rt.Signature(3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rt.Signature(3)
    assert rt.Signature(3, device="cpu").device.type == "cpu"


def test_gpu_backend_refuses_cpu_tensors():
    x = torch.from_numpy(paths(16, 2, 5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rt.signature(x, 3, backend="gpu")


@pytest.mark.parametrize("backend", ["gpu", "antidiag"])
def test_stream_refuses_other_backends(backend):
    x = torch.from_numpy(paths(17, 2, 5))
    with pytest.raises(ValueError):
        rt.signature(x, 3, stream=True, backend=backend)


def test_signature_dispatch():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for op in ("signature", "logsignature"):
        assert dispatch.resolve("auto", op=op, device=cuda) == "gpu"
        assert dispatch.resolve("auto", op=op, device=cpu) == "reference"
        assert dispatch.backends_for(op) == ("gpu", "reference")
    with pytest.raises(ValueError, match="does not implement op"):
        rt.signature(torch.from_numpy(paths(18, 2, 5)), 3, backend="gpu_fused")


def test_cpu_signatures_launch_no_kernel():
    kernel.reset_launch_counts()
    x = torch.from_numpy(paths(19, 2, 6)).requires_grad_()
    rt.signature(x, 3).sum().backward()
    ops.signature_from_increments(x, 3)
    rt.logsignature(x, 3, mode="brackets")
    assert kernel.launch_counts() == {"horner": 0}


def test_launch_geometry_fits_the_card():
    """At the paper's Table 1 cells the split launch fills the card with
    blocks whose top-level slice fits their threads' registers, whose step
    takes about one row item a thread, and whose staging fits shared
    memory; caps move only the geometry."""
    for (d, N, L), (p, blocks) in zip([(4, 6, 256), (8, 5, 512), (16, 4, 1024)],
                                      [(1, 512), (1, 1024), (1, 2048)]):
        geo = ops.geometry(128, L - 1, d, N)
        assert geo[:2] == (p, d) and 128 * d ** p == blocks
        p, jw, cw, S, threads = geo
        assert S >= 8 and kernel.smem_bytes(d, N, p, cw, S, threads) <= 48 * 1024
        tiles = d * -(-kernel.top_rows(d, N, p) // kernel.TOP)
        items = kernel.row_items(d, N, p, cw)
        assert threads == kernel.threads_needed(d, N, p, jw, cw) == \
            -(-max(items, tiles) // 32) * 32 <= kernel.MAX_THREADS
        assert ops.geometry(128, L - 1, d, N, max_lb=4)[3] == 4
        small = ops.geometry(128, L - 1, d, N, max_threads=32)
        assert small[4] == 32 and small[0] > p
    assert ops.geometry(1, 1, 3, 3)[3] == 1
    assert ops.geometry(4, 9, 2, 2)[4] == 32
    # (16, 5) and lead-lag + time-aug at N = 6 (d' = 9) fit: a longer prefix
    assert ops.geometry(128, 255, 16, 5)[0] == 2
    assert ops.geometry(128, 255, 9, 6)[0] >= 2
    # per path and step, Horner's operations at the paper's Table 1 widths
    assert [kernel.horner_flops(d, N) for d, N in [(4, 6), (8, 5), (16, 4)]] == \
        [14580, 85624, 149152]


@pytest.mark.parametrize("B", [1, 128])
def test_launch_geometry_takes_every_width_and_depth(B):
    """No (d, N) with d <= 16, N <= 6 is refused, with or without caps, and
    each geometry is one the kernel takes (its host-side checks)."""
    for d in range(1, 17):
        for N in range(1, 7):
            for caps in ((None, None), (32, 1), (64, 4)):
                p, jw, cw, S, threads = ops.geometry(B, 100, d, N, *caps)
                assert 0 <= p <= max(N - 1, 0) and 1 <= jw <= d and S >= 1
                assert cw in (1, 2, 4) and threads % 32 == 0
                assert kernel.threads_needed(d, N, p, jw, cw) <= threads <= \
                    (caps[0] or kernel.MAX_THREADS)
                assert kernel.smem_bytes(d, N, p, cw, S, threads) <= kernel.SMEM_LIMIT
                assert B * d ** p * -(-d // jw) <= 2 ** 31 - 1
    # past 512 channels the top level's columns are cut into chunks
    assert ops.geometry(1, 3, 1100, 2)[:2] == (1, 512)


def test_launch_config_carries_the_horner_knobs():
    jl = repro.LaunchConfig(sig_bt=64, sig_lb=16, pde_strip=32)
    fields = {k: np.asarray(v) if v is not None else None
              for k, v in dataclasses.asdict(jl).items()}
    launch = rt.configs_from_reference({"launch": fields})["launch"]
    assert (launch.sig_bt, launch.sig_lb, launch.pde_strip) == (64, 16, 32)
    with pytest.raises(ValueError, match="power of two"):
        rt.LaunchConfig(sig_lb=12)


def test_sigkernel_scoring_rule_matches_jax():
    X, y = paths(20, 4, 8), paths(21, 1, 10)[0]
    jmod = repro.SigKernel(transforms=TRANSFORMS["time_aug"])
    tmod = rt.SigKernel(transforms=port_transforms(TRANSFORMS["time_aug"]), device="cpu")
    with jax.enable_x64(True):
        want = jmod.scoring_rule(jnp.asarray(X), jnp.asarray(y), length_y=7)
        want_s = jmod.scoring_rule(jnp.asarray(X), jnp.asarray(y), row_block=2)
    close(tmod.scoring_rule(X, y, length_y=7), want, 1e-10)
    close(tmod.scoring_rule(X, y, row_block=2), want_s, 1e-10)
