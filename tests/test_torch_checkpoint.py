"""The port's checkpoint manager and the AdamW state as a tree, against the
JAX package's, on the CPU.

The five cases of ``tests/test_checkpoint.py`` run on the port's manager
(``device=`` in place of ``shardings=``).  Across packages, a tree of
float32, int32-scalar and bfloat16 leaves written by either manager
restores in the other with the same names, shapes, dtype strings and bits
(the JAX manager hands a bfloat16 leaf back as numpy's ``V2``, ROADMAP
C11, so its side compares bits).  An async save whose source is changed in
place right after ``save`` returns still restores what ``save`` saw.  A
missing, extra, mis-shaped or mis-typed leaf is refused by name, and a
failed background write raises from ``wait``.

State carried across: on the reduced deepseek-7b with ``sig_loss`` on, the
JAX ``(params, AdamWState)`` after two steps of the JAX train step is saved
by the JAX manager and restored by the port's into its model and
``AdamW`` (bit for bit), and the reverse from two port steps; then both
packages take a third step on the same numpy batch.  The parameters agree
as ``tests/test_torch_train.py`` holds one step (within 1e-3 lr where the
JAX gradient is at least 1e-6, 0.1 lr everywhere); the moments, a leaf at a
time, within the gradient's 2e-4 norm-relative gate (2× that for ``v``, a
square of it), plus one bfloat16 rounding (2^-8) with bfloat16 moments.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.params import tree_items
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import make_train_step

from test_torch_train import carried_lm, lm_batch

jax.config.update("jax_platform_name", "cpu")


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 3), generator=g),
            "b": {"w": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  "s": torch.tensor(3.5)}}


def leaves(t):
    return [v for _, v in tree_items(t)]


def int_bits(x):
    """A tensor's or array's bits as integers (floats compared bit for bit)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()])
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.kind in "fV":
        x = x.view({2: np.int16, 4: np.int32, 8: np.int64}[x.dtype.itemsize])
    return x


def assert_same_bits(a, b, what=""):
    a, b = int_bits(a), int_bits(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's five cases
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save(5, t, blocking=True)
    restored, step = mgr.restore(5, t)
    assert step == 5
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype
        assert_same_bits(a, b)


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for s in (1, 2, 3):
        mgr.save(s, tree(s))
    mgr.wait()
    assert mgr.latest_step() == 3


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        mgr.save(s, tree(), blocking=True)
    assert mgr.all_steps() == [4, 5]


def test_no_tmp_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, tree(), blocking=True)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_restore_with_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save(1, t, blocking=True)
    restored, _ = mgr.restore(1, t, device=torch.device("cpu"))
    assert all(x.device == torch.device("cpu") for x in leaves(restored))
    for a, b in zip(leaves(t), leaves(restored)):
        assert_same_bits(a, b)


# ---------------------------------------------------------------------------
# the port's own guarantees
# ---------------------------------------------------------------------------

def test_async_snapshot_is_a_copy(tmp_path):
    """The port's optimizer updates tensors in place: what save saw is what
    restores, however the source changes while the write runs."""
    mgr = CheckpointManager(str(tmp_path))
    t = {"p": torch.randn(256, 64, generator=torch.Generator().manual_seed(0)),
         "m": torch.ones(8, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in t.items()}
    mgr.save(1, t)
    t["p"].mul_(-3.0).add_(1.0)
    t["m"].zero_()
    mgr.wait()
    restored, _ = mgr.restore(1, t)
    for k in t:
        assert_same_bits(restored[k], want[k], k)


def test_timings_record_each_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = tree()
    mgr.save(1, t)
    mgr.save(2, t, blocking=True)
    assert [r["step"] for r in mgr.timings] == [1, 2]
    assert all(r["write_s"] > 0 and r["snapshot_s"] >= 0 for r in mgr.timings)
    assert mgr.timings[0]["bytes"] == 4 * 12 + 4 * 6 + 4


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_restore_refuses_a_mismatched_leaf_by_name(tmp_path, fault):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree(), blocking=True)
    target = tree()
    if fault == "missing":
        target["b"]["new"] = torch.zeros(2)
        name = "b/new"
    elif fault == "extra":
        del target["b"]["s"]
        name = "b/s"
    elif fault == "shape":
        target["a"] = torch.zeros(3, 4)
        name = "a"
    else:
        target["b"]["w"] = target["b"]["w"].long()
        name = "b/w"
    with pytest.raises(ValueError, match=name):
        mgr.restore(1, target)


def test_failed_background_write_raises_from_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    open(os.path.join(tmp_path, "step_3.tmp"), "w").close()     # a file where the dir goes
    mgr.save(3, tree())
    with pytest.raises(RuntimeError, match="checkpoint write"):
        mgr.wait()
    mgr.wait()                                                    # raised once
    assert mgr.all_steps() == []


def test_leaf_names_and_order_follow_jax_flattening(tmp_path):
    """Dict keys sorted (not insertion order), sequence positions by index,
    joined by '/': the (params, AdamW state) pair's names and order are the
    JAX (params, AdamWState) pair's."""
    params = {"z": {"b": np.ones(2, np.float32), "a": np.ones(3, np.float32)},
              "layer_10": np.ones(1, np.float32), "layer_2": np.ones(1, np.float32)}
    jtree = (jax.tree.map(jnp.asarray, params), JAdamW(lr=jcosine(1e-3, 2, 5)).init(params))
    JCheckpointManager(str(tmp_path / "j")).save(1, jtree, blocking=True)
    nested = {"z": {"b": torch.nn.Parameter(torch.ones(2)),
                    "a": torch.nn.Parameter(torch.ones(3))},
              "layer_10": torch.nn.Parameter(torch.ones(1)),
              "layer_2": torch.nn.Parameter(torch.ones(1))}
    opt = AdamW([p for _, p in tree_items(nested)], lr=cosine_schedule(1e-3, 2, 5))
    CheckpointManager(str(tmp_path / "t")).save(1, (nested, opt.state_tree(nested)),
                                                blocking=True)
    manifests = [json.load(open(tmp_path / d / "step_1" / "manifest.json")) for d in "jt"]
    for key in ("names", "shapes", "dtypes", "step", "n_processes"):
        assert manifests[0][key] == manifests[1][key], key
    assert manifests[1]["names"][:4] == ["0/layer_10", "0/layer_2", "0/z/a", "0/z/b"]
    assert manifests[1]["names"][4] == "1/count"


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def mixed_numpy():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "opt": {"count": np.array(7, np.int32),
                    "m": rng.normal(size=(4, 6)).astype(np.float32)},
            "h": (rng.normal(size=(2, 7)) * 3).astype(np.float32)}


def target_dtype(target, name):
    return dict(tree_items(target))[name].dtype


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    src = mixed_numpy()
    jtree = {"w": jnp.asarray(src["w"]), "h": jnp.asarray(src["h"], jnp.bfloat16),
             "opt": {"count": jnp.int32(7), "m": jnp.asarray(src["opt"]["m"])}}
    JCheckpointManager(str(tmp_path)).save(4, jtree, blocking=True)
    target = {"w": torch.zeros(5, 3), "h": torch.zeros(2, 7, dtype=torch.bfloat16),
              "opt": {"count": torch.tensor(0, dtype=torch.int32), "m": torch.zeros(4, 6)}}
    got, step = CheckpointManager(str(tmp_path)).restore(4, target)
    assert step == 4
    want = dict(tree_items(jtree))
    for name, leaf in tree_items(got):
        assert leaf.dtype == target_dtype(target, name)
        assert tuple(leaf.shape) == want[name].shape
        assert_same_bits(leaf, np.asarray(want[name]), name)
    assert got["opt"]["count"].item() == 7


def test_port_checkpoint_restores_in_jax(tmp_path):
    src = mixed_numpy()
    ttree = {"w": torch.from_numpy(src["w"]),
             "h": torch.from_numpy(src["h"]).to(torch.bfloat16),
             "opt": {"count": torch.tensor(7, dtype=torch.int32),
                     "m": torch.from_numpy(src["opt"]["m"])}}
    CheckpointManager(str(tmp_path)).save(4, ttree, blocking=True)
    jtarget = {"w": jnp.zeros((5, 3)), "h": jnp.zeros((2, 7), jnp.bfloat16),
               "opt": {"count": jnp.int32(0), "m": jnp.zeros((4, 6))}}
    got, step = JCheckpointManager(str(tmp_path)).restore(4, jtarget)
    assert step == 4
    meta = json.load(open(tmp_path / "step_4" / "manifest.json"))
    assert meta["names"] == ["h", "opt/count", "opt/m", "w"]
    assert meta["dtypes"] == ["bfloat16", "int32", "float32", "float32"]
    assert meta["shapes"] == [[2, 7], [], [4, 6], [5, 3]]
    want = dict(tree_items(ttree))
    for name, leaf in tree_items(got):
        leaf = np.asarray(leaf)
        assert leaf.shape == tuple(want[name].shape)
        assert_same_bits(want[name], leaf, name)
    assert np.asarray(got["h"]).dtype == np.dtype("V2")          # ROADMAP C11
    assert int(got["opt"]["count"]) == 7


# ---------------------------------------------------------------------------
# state carried across, and a third step in both
# ---------------------------------------------------------------------------

SCHED = (1e-3, 2, 50)
GRAD_REL = 2e-4


def jax_batch(tm, seed):
    return {k: jnp.asarray(v) for k, v in lm_batch(tm.cfg.vocab, tm.cfg.sig_loss_dim, seed).items()}


def port_batch(tm, seed):
    return {k: torch.from_numpy(v) for k, v in lm_batch(tm.cfg.vocab, tm.cfg.sig_loss_dim,
                                                         seed).items()}


def jax_state_as_numpy(state, moment_dtype):
    """The JAX manager's restore of a port checkpoint as the JAX step takes
    it: V2 leaves (the moments in bf16) viewed as bfloat16."""
    def fix(x):
        x = np.asarray(x)
        return jnp.asarray(x.view(jnp.bfloat16) if x.dtype == np.dtype("V2") else x)
    return jax.tree.map(fix, state)


def assert_state_equals(tm, opt, jp, jstate):
    """The port's parameters and AdamW state against a JAX pair, bit for bit."""
    jparams = dict(tree_items(jp))
    for name, p in tree_items(tm.tree()):
        assert_same_bits(p, np.asarray(jparams[name]), name)
    st = opt.state_tree(tm.tree())
    assert int(st["count"]) == int(jstate.count)
    for key in ("m", "v"):
        jm = dict(tree_items(getattr(jstate, key)))
        for name, m in tree_items(st[key]):
            assert str(m.dtype).replace("torch.", "") == str(jm[name].dtype)
            assert_same_bits(m, np.asarray(jm[name]), f"{key} {name}")


def assert_third_step_agrees(jm, jp2, jstate2, tm, opt, moment_dtype):
    jopt = JAdamW(lr=jcosine(*SCHED), moment_dtype=moment_dtype)
    jbatch = jax_batch(tm, 2)
    jp3, jstate3, _ = jax.jit(jmake_train_step(jm, jopt))(jp2, jstate2, jbatch)
    jgrad = dict(tree_items(jax.tree.map(
        np.asarray, jax.jit(jax.grad(lambda p: jm.loss(p, jbatch)[0]))(jp2))))
    before = {k: v.detach().clone().numpy() for k, v in tm.state_dict().items()}
    make_train_step(tm, opt)(port_batch(tm, 2))
    lr = cosine_schedule(*SCHED)(3)
    after = dict(tree_items(jax.tree.map(np.asarray, jp3)))
    for name, p in tm.named_parameters():
        du = np.abs((p.detach().numpy() - before[name]) - (after[name] - before[name]))
        assert du[np.abs(jgrad[name]) >= 1e-6].max(initial=0.0) <= 1e-3 * lr, name
        assert du.max() <= 0.1 * lr, name
    st = opt.state_tree(tm.tree())
    assert int(st["count"]) == int(jstate3.count) == 3
    rounding = 2.0 ** -8 if moment_dtype == "bfloat16" else 0.0
    for key, gate in (("m", GRAD_REL), ("v", 2 * GRAD_REL)):
        want = dict(tree_items(jax.tree.map(lambda x: np.asarray(x, np.float64),
                                            getattr(jstate3, key))))
        for name, t in tree_items(st[key]):
            got = t.double().numpy()
            assert (np.linalg.norm(got - want[name])
                    <= (gate + rounding) * np.linalg.norm(want[name])), (key, name)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_jax_state_carried_into_the_port_steps_alike(tmp_path, moment_dtype):
    jm, jp, tm = carried_lm()
    jopt = JAdamW(lr=jcosine(*SCHED), moment_dtype=moment_dtype)
    jstep = jax.jit(jmake_train_step(jm, jopt))
    jstate = jopt.init(jp)
    for seed in range(2):
        jp, jstate, _ = jstep(jp, jstate, jax_batch(tm, seed))
    JCheckpointManager(str(tmp_path)).save(2, (jp, jstate), blocking=True)
    opt = AdamW(tm.parameters(), lr=cosine_schedule(*SCHED), moment_dtype=moment_dtype)
    (params, state), step = CheckpointManager(str(tmp_path)).restore(
        2, (tm.tree(), opt.state_tree(tm.tree())))
    assert step == 2
    with torch.no_grad():
        for (_, p), (_, v) in zip(tree_items(tm.tree()), tree_items(params)):
            p.copy_(v)
    opt.load_state_tree(tm.tree(), state)
    assert_state_equals(tm, opt, jp, jstate)
    assert_third_step_agrees(jm, jp, jstate, tm, opt, moment_dtype)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_port_state_carried_into_jax_steps_alike(tmp_path, moment_dtype):
    jm, jp, tm = carried_lm()
    opt = AdamW(tm.parameters(), lr=cosine_schedule(*SCHED), moment_dtype=moment_dtype)
    step = make_train_step(tm, opt)
    for seed in range(2):
        step(port_batch(tm, seed))
    CheckpointManager(str(tmp_path)).save(2, (tm.tree(), opt.state_tree(tm.tree())),
                                          blocking=True)
    jopt = JAdamW(lr=jcosine(*SCHED), moment_dtype=moment_dtype)
    (jp2, jstate2), s = JCheckpointManager(str(tmp_path)).restore(2, (jp, jopt.init(jp)))
    assert s == 2
    jp2, jstate2 = jax_state_as_numpy(jp2, moment_dtype), jax_state_as_numpy(jstate2,
                                                                             moment_dtype)
    assert_state_equals(tm, opt, jp2, jstate2)
    assert_third_step_agrees(jm, jp2, jstate2, tm, opt, moment_dtype)


def test_state_tree_before_the_first_step_is_adamw_init():
    """Zero moments in moment_dtype and count 0, as AdamW.init gives; loading
    it into a fresh optimizer sets the count the schedule reads."""
    params = {"w": torch.nn.Parameter(torch.ones(3, 2)), "b": torch.nn.Parameter(torch.ones(2))}
    opt = AdamW(params.values(), lr=lambda step: 0.1 * step, moment_dtype="bfloat16")
    st = opt.state_tree(params)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    assert all(m.dtype == torch.bfloat16 and not m.any() for _, m in tree_items(st["m"]))
    st["count"] = torch.tensor(4, dtype=torch.int32)
    fresh = AdamW(params.values(), lr=lambda step: 0.1 * step, moment_dtype="bfloat16")
    fresh.load_state_tree(params, st)
    assert fresh.state["count"] == 4
    with pytest.raises(ValueError, match="name the parameters"):
        fresh.load_state_tree({"w": params["w"]}, st)
