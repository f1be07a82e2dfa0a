"""The port's optimizer, train step and example trainer against the JAX
package's, on the CPU.

``AdamW`` and ``cosine_schedule`` take three steps on fed gradients (a
leaf with ``ndim < 2``, which gets no weight decay, a parameter without a
gradient, and one step whose norm the clip scales) and agree with
``repro.optim.adamw`` within 1e-6.  ``make_train_step`` and
``make_eval_step`` run the reduced deepseek-7b LM, its signature-kernel
auxiliary loss on, from the JAX package's initial parameters; after one
step (one and two microbatches) the updated parameters agree with the JAX
step's.  The port's own 15-step run lowers its loss by 0.5, as
``tests/test_models.py`` asks of the JAX LM, and the example trainer runs
from its command line.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro.train.step import apply_param_dtype as japply_param_dtype
from repro.train.step import cast_compute as jcast_compute
from repro.train.step import make_eval_step as jmake_eval_step
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.models import build_model, get_config, params_from_jax
from repro_torch.models.params import tree_items
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import (apply_param_dtype, cast_compute, make_eval_step,
                               make_train_step)

ROOT = os.path.join(os.path.dirname(__file__), "..")

OPT_TOL = 1e-6


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def as_np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float64)


@pytest.mark.parametrize("peak,warmup,total,floor", [(1e-3, 20, 200, 0.1), (3e-4, 2, 50, 0.1),
                                                     (1.0, 0, 10, 0.0), (1e-3, 5, 5, 0.2)])
def test_cosine_schedule_matches_jax(peak, warmup, total, floor):
    port, ref = cosine_schedule(peak, warmup, total, floor), jcosine(peak, warmup, total, floor)
    for step in range(0, total + 10):
        assert rel(port(step), ref(jnp.asarray(step, jnp.int32))) <= OPT_TOL, step


#: the fed parameters: two matrices (decayed), a vector and a one-element
#: leaf (not decayed)
SHAPES = {"w": (3, 4), "u": (2, 3, 2), "b": (4,), "s": (1,)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax_on_fed_gradients(moment_dtype, weight_decay):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    # step 2's gradients are large: the global-norm clip scales them
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}
             for scale in (0.1, 30.0, 0.2)]
    grads[2]["s"] = np.zeros(SHAPES["s"], np.float32)    # the port's p.grad is None
    sched = dict(peak=1e-2, warmup=2, total=10)
    jopt = JAdamW(lr=jcosine(**sched), weight_decay=weight_decay, moment_dtype=moment_dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(tp.values(), lr=cosine_schedule(**sched), weight_decay=weight_decay,
                moment_dtype=moment_dtype)
    norms = []
    for g in grads:
        jp, jstate, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        for k, p in tp.items():
            p.grad = None if k == "s" and not g[k].any() else torch.from_numpy(g[k].copy())
        out = opt.step()
        norms.append(float(jm["grad_norm"]))
        assert rel(out["grad_norm"], jm["grad_norm"]) <= OPT_TOL
        for k, p in tp.items():
            assert rel(as_np(p), jp[k]) <= OPT_TOL, k
            assert opt.state[p]["m"].dtype == getattr(torch, moment_dtype)
            assert rel(as_np(opt.state[p]["m"]), jstate.m[k].astype(jnp.float32)) <= OPT_TOL
            assert rel(as_np(opt.state[p]["v"]), jstate.v[k].astype(jnp.float32)) <= OPT_TOL
    assert norms[1] > 1.0 > norms[0]            # the clip took part
    assert opt.state["count"] == int(jstate.count) == 3


def test_adamw_decays_only_matrices():
    w, b = torch.nn.Parameter(torch.ones(2, 2)), torch.nn.Parameter(torch.ones(2))
    opt = AdamW([w, b], lr=lambda step: 0.5, weight_decay=0.1)
    w.grad, b.grad = torch.zeros(2, 2), torch.zeros(2)
    opt.step()
    assert torch.allclose(w.detach(), torch.full((2, 2), 1 - 0.5 * 0.1))
    assert torch.equal(b.detach(), torch.ones(2))


def test_cast_compute_and_param_dtype_match_jax():
    tree = {"a": np.ones((2, 3), np.float32), "b": {"s": np.ones((), np.float32),
                                                   "i": np.arange(3, dtype=np.int64)}}
    ttree = {"a": torch.ones(2, 3), "b": {"s": torch.ones(()), "i": torch.arange(3)}}
    got = dict(tree_items(cast_compute(ttree, torch.bfloat16)))
    want = dict(tree_items(jcast_compute(tree, jnp.bfloat16)))
    assert {k: str(v.dtype).replace("torch.", "") for k, v in got.items()} == \
        {k: str(v.dtype).replace("int32", "int64") for k, v in want.items()}
    cfg = get_config("nemotron-4-340b")
    got = dict(tree_items(apply_param_dtype(ttree, cfg)))
    want = dict(tree_items(japply_param_dtype(tree, jget_config("nemotron-4-340b"))))
    assert {k: str(v.dtype).replace("torch.", "") for k, v in got.items()} == \
        {k: str(v.dtype).replace("int32", "int64") for k, v in want.items()}


# ---------------------------------------------------------------------------
# the train step on the reduced LM
# ---------------------------------------------------------------------------

B, S = 2, 12


def lm_batch(vocab, sig_dim, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S))
    target = np.cumsum(rng.normal(size=(B, 32, sig_dim)) * 0.1, axis=1).astype(np.float32)
    return {"tokens": toks, "labels": toks, "sig_target": target}


def carried_lm(sig_loss=True):
    jcfg = jget_config("deepseek-7b").reduced().replace(sig_loss=sig_loss)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("deepseek-7b").reduced().replace(sig_loss=sig_loss),
                     device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_train_step_matches_jax(num_microbatches):
    """One step of each package from the same parameters and batch.

    The loss, the metrics and the gradient norm within 5e-5; the averaged
    gradient the port hands the optimizer (``p.grad``) within 2e-4
    norm-relative of the mean of ``jax.grad`` over the same microbatches;
    the updated parameters elementwise within 1e-3 lr of the JAX step's
    where |g| >= 1e-6.  Adam's first update is g / (|g| + eps) per element,
    which turns the gradients' float32 rounding into update differences
    where |g| is near eps = 1e-8 (measured: up to 0.02 lr, at elements with
    |g| <= 2.2e-7); there the bound is 0.1 lr."""
    jm, jp, tm = carried_lm()
    batch = lm_batch(tm.cfg.vocab, tm.cfg.sig_loss_dim)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    sched = (1e-3, 2, 50)
    lr = cosine_schedule(*sched)(1)
    jopt = JAdamW(lr=jcosine(*sched))
    jstep = jmake_train_step(jm, jopt, num_microbatches=num_microbatches)
    jp2, _, jmet = jstep(jp, jopt.init(jp), jbatch)
    n = num_microbatches
    jgrads = [jax.grad(lambda p: jm.loss(p, {k: v[i * B // n:(i + 1) * B // n]
                                               for k, v in jbatch.items()})[0])(jp)
              for i in range(n)]
    jgrad = dict(tree_items(jax.tree.map(lambda *g: np.asarray(sum(g)) / n, *jgrads)))
    step = make_train_step(tm, AdamW(tm.parameters(), lr=cosine_schedule(*sched)),
                           num_microbatches=n)
    before = {k: v.detach().clone().numpy() for k, v in tm.state_dict().items()}
    met = step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(met) == set(jmet)
    for k in met:
        assert rel(as_np(met[k]), jmet[k]) <= 5e-5, k
    after = dict(tree_items(jax.tree.map(np.asarray, jp2)))
    for name, p in tm.named_parameters():
        g, want = p.grad.numpy(), jgrad[name]
        assert np.linalg.norm(g - want) <= 2e-4 * np.linalg.norm(want), name
        du = np.abs((p.detach().numpy() - before[name]) - (after[name] - before[name]))
        assert du[np.abs(want) >= 1e-6].max(initial=0.0) <= 1e-3 * lr, name
        assert du.max() <= 0.1 * lr, name


def test_eval_step_matches_jax():
    jm, jp, tm = carried_lm()
    batch = lm_batch(tm.cfg.vocab, tm.cfg.sig_loss_dim, seed=1)
    want = jmake_eval_step(jm)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(tm)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in got:
        assert not got[k].requires_grad
        assert rel(as_np(got[k]), want[k]) <= 5e-5, k


def test_bf16_accumulation_and_compute_run():
    """accum_dtype and compute_dtype bfloat16: the master copy stays float32
    and moves."""
    tm = build_model(get_config("deepseek-7b").reduced().replace(compute_dtype="bfloat16"),
                     device="cpu")
    before = tm.embed.table.detach().clone()
    step = make_train_step(tm, AdamW(tm.parameters(), lr=cosine_schedule(1e-3, 2, 50)),
                           num_microbatches=2, accum_dtype="bfloat16")
    met = step({k: torch.from_numpy(v) for k, v in lm_batch(256, 4).items()
                if k != "sig_target"})
    assert np.isfinite(float(met["loss"])) and np.isfinite(float(met["grad_norm"]))
    assert tm.embed.table.dtype == torch.float32
    assert not torch.equal(tm.embed.table.detach(), before)


def test_train_step_decreases_loss():
    """The port's own 15-step run (its own initial parameters), as
    tests/test_models.py::test_train_step_decreases_loss runs the JAX LM."""
    tm = build_model(get_config("deepseek-7b").reduced(), device="cpu")
    step = make_train_step(tm, AdamW(tm.parameters(), lr=cosine_schedule(1e-3, 2, 50)),
                           num_microbatches=2)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab, size=(B, S)))
    batch = {"tokens": toks, "labels": toks}
    losses = [float(step(batch)["loss"]) for _ in range(15)]
    assert losses[-1] < losses[0] - 0.5, losses


def test_example_trainer_runs_on_the_cpu():
    """examples/train_sigkernel_gan_torch.py from its command line."""
    done = subprocess.run(
        [sys.executable, "examples/train_sigkernel_gan_torch.py", "--steps", "3", "--batch",
         "4", "--length", "8", "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src"}, timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr
    m = re.search(r"^eval MMD\^2: (\S+) -> (\S+) \((improved|NOT improved)\)$", done.stdout,
                  re.M)
    assert m, done.stdout
    assert np.isfinite(float(m.group(1))) and np.isfinite(float(m.group(2)))
    assert "generator params: 0.1M on cpu" in done.stdout
