"""The port's vlm family (the dense LM behind stubbed patch embeddings,
``Model.embed_inputs``) against the JAX package's, on the CPU.

The JAX initialiser's parameters, carried across by
:func:`repro_torch.models.params_from_jax`, and the same numpy inputs from a
seed go through both in float32 at the reduced internvl2-76b config (2
layers of width 64, 8 patches of 1,024), per layer and stacked.  With
``sig_loss`` on, at (S, P) = (12, 8) and (8, 8): the loss and its metrics
within 5e-5 relative, every parameter's gradient (``patch_proj``'s and
``embed``'s among them) within 2e-4 norm-relative of ``jax.grad``, and the
embedding rows of tokens that only the patches overwrite get no gradient
in either package, exactly.  A batch without ``"patches"`` is the dense LM
in both.  At P > S (6 tokens, 8 patches) the port's loss raises
``ValueError`` where the JAX loss raises, and its prefill's logits and
every cache leaf (8 positions) match JAX's.  One ``make_train_step`` with
two microbatches (``patches`` split with the tokens) matches the JAX train
step.  At full size, the parameters' names and shapes and their count,
70,562,095,104, are the JAX initialiser's (``jax.eval_shape``), drawn by the
port's initialiser under ``FakeTensorMode`` (no storage: a full-width layer
is 3.42 GB in float32).  ``tests/test_torch_serve_lm.py`` holds the serving
methods with patches beside the other families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.models import build_model, get_config, params_from_jax
from repro_torch.models.api import init_params
from repro_torch.models.params import tree_items
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import make_train_step

VALUE_RTOL = 5e-5      # losses, metrics, logits and caches
GRAD_RTOL = 2e-4       # gradients, norm-relative
LAYOUTS = {"layers": False, "stacked": True}
FULL_COUNT = 70_562_095_104


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def rel(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def norm_rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def pair(scan, **kw):
    """(JAX model, its parameters as numpy, the port's model carrying them):
    reduced internvl2-76b in a layout, rematerialised where stacked."""
    jcfg, cfg = (get("internvl2-76b").reduced().replace(scan_layers=scan, remat=scan, **kw)
                 for get in (jget_config, get_config))
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jp))
    return jm, jp, tm


def batch_of(cfg, B, S, P, seed=0, sig=True):
    """S tokens and labels, P patches of 0.1·N(0, 1) (none at P = 0) and,
    under ``sig``, the sig-aux targets, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if P:
        out["patches"] = f32(rng, B, P, 1024, scale=0.1)
    if sig:
        out["sig_target"] = np.cumsum(f32(rng, B, 32, cfg.sig_loss_dim, scale=0.1), axis=1)
    return out


def loss_and_grads(jm, jp, tm, batch):
    """Both packages' (loss, metrics, gradients by name) on one batch."""
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm.zero_grad()
    loss, met = tm.loss({k: t(v) for k, v in batch.items()})
    loss.backward()
    grads = {name: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for name, p in tm.named_parameters()}
    return (loss, met, grads), (jl, jmet, dict(tree_items(jax.tree.map(np.asarray, jg))))


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,P", [(12, 8), (8, 8)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_and_gradients_match_jax(layout, S, P):
    """sig_loss on; every parameter's gradient, patch_proj's and embed's
    included; the rows of tokens only the patches overwrite get none."""
    jm, jp, tm = pair(LAYOUTS[layout], sig_loss=True)
    batch = batch_of(tm.cfg, 2, S, P, seed=S)
    (loss, met, grads), (jl, jmet, jgrads) = loss_and_grads(jm, jp, tm, batch)
    assert rel(loss, jl) <= VALUE_RTOL
    assert set(met) == set(jmet) == {"ce", "aux", "sig"}
    for k in met:
        assert rel(met[k], jmet[k]) <= VALUE_RTOL, k
    assert set(grads) == set(jgrads) and "patch_proj" in grads
    for name, g in grads.items():
        assert norm_rel(g, jgrads[name]) <= GRAD_RTOL, name
    assert np.abs(grads["patch_proj"]).max() > 0
    seen = np.unique(batch["tokens"][:, P:])
    hidden = np.setdiff1d(np.unique(batch["tokens"][:, :P]), seen)
    if S == P:
        assert seen.size == 0 and hidden.size > 0
    assert np.all(grads["embed.table"][hidden] == 0)
    assert np.all(jgrads["embed.table"][hidden] == 0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_batch_without_patches_is_the_dense_lm(layout):
    """No "patches": the loss, the logits of a prefill and every gradient are
    JAX's, and patch_proj gets a zero gradient in both packages."""
    jm, jp, tm = pair(LAYOUTS[layout], sig_loss=True)
    batch = batch_of(tm.cfg, 2, 12, 0, seed=3)
    (loss, _, grads), (jl, _, jgrads) = loss_and_grads(jm, jp, tm, batch)
    assert rel(loss, jl) <= VALUE_RTOL
    for name, g in grads.items():
        assert norm_rel(g, jgrads[name]) <= GRAD_RTOL, name
    assert not np.any(grads["patch_proj"]) and not np.any(jgrads["patch_proj"])
    jlog, _ = jm.prefill(jp, {"tokens": jnp.asarray(batch["tokens"])})
    logits, _ = tm.prefill({"tokens": t(batch["tokens"])})
    V = tm.cfg.vocab
    assert rel(logits[..., :V], np.asarray(jlog)[..., :V]) <= VALUE_RTOL


# ---------------------------------------------------------------------------
# more patches than tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_more_patches_than_tokens(layout):
    """(S, P) = (6, 8): the loss raises in both packages; prefill runs over
    the 8 patch positions in both, the last patch's logits and a cache of 8
    positions equal."""
    jm, jp, tm = pair(LAYOUTS[layout])
    batch = batch_of(tm.cfg, 2, 6, 8, seed=5, sig=False)
    with pytest.raises(ValueError):
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="8 patches need at least 8 tokens and labels"):
        tm.loss({k: t(v) for k, v in batch.items()})
    prompt = {"tokens": batch["tokens"], "patches": batch["patches"]}
    jlog, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in prompt.items()})
    logits, caches = tm.prefill({k: t(v) for k, v in prompt.items()})
    V = tm.cfg.vocab
    assert rel(logits[..., :V], np.asarray(jlog)[..., :V]) <= VALUE_RTOL
    want = dict(tree_items(jax.tree.map(np.asarray, jc)))
    got = dict(tree_items(caches))
    assert set(got) == set(want)
    for name, v in got.items():
        assert v.shape[-3] == 8, name
        assert rel(v, want[name]) <= VALUE_RTOL, name


# ---------------------------------------------------------------------------
# the train step: microbatches split the patches
# ---------------------------------------------------------------------------

def test_train_step_with_two_microbatches_matches_jax():
    """One step of each package from the same parameters and batch (4
    sequences of 12 tokens, 8 patches, sig_loss on) in two microbatches:
    the metrics within 5e-5, the averaged gradient within 2e-4
    norm-relative, the updated parameters within 1e-3 lr where |g| >= 1e-6
    (``tests/test_torch_train.py``'s bounds)."""
    jm, jp, tm = pair(True, sig_loss=True)
    batch = batch_of(tm.cfg, 4, 12, 8, seed=7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    sched = (1e-3, 2, 50)
    lr = cosine_schedule(*sched)(1)
    jopt = JAdamW(lr=jcosine(*sched))
    jp2, _, jmet = jmake_train_step(jm, jopt, num_microbatches=2)(jp, jopt.init(jp), jbatch)
    jgrads = [jax.grad(lambda p: jm.loss(p, {k: v[i * 2:(i + 1) * 2]
                                               for k, v in jbatch.items()})[0])(jp)
              for i in range(2)]
    jgrad = dict(tree_items(jax.tree.map(lambda *g: np.asarray(sum(g)) / 2, *jgrads)))
    step = make_train_step(tm, AdamW(tm.parameters(), lr=cosine_schedule(*sched)),
                           num_microbatches=2)
    before = {k: v.detach().clone().numpy() for k, v in tm.state_dict().items()}
    met = step({k: t(v) for k, v in batch.items()})
    assert set(met) == set(jmet)
    for k in met:
        assert rel(met[k].detach().float(), jmet[k]) <= VALUE_RTOL, k
    after = dict(tree_items(jax.tree.map(np.asarray, jp2)))
    for name, p in tm.named_parameters():
        g, want = p.grad.numpy(), jgrad[name]
        assert norm_rel(g, want) <= GRAD_RTOL, name
        du = np.abs((p.detach().numpy() - before[name]) - (after[name] - before[name]))
        assert du[np.abs(want) >= 1e-6].max(initial=0.0) <= 1e-3 * lr, name
        assert du.max() <= 0.1 * lr, name
    assert np.abs(jgrad["patch_proj"]).max() > 0


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reduced_names_are_the_jax_initialisers(layout):
    jm, jp, tm = pair(LAYOUTS[layout])
    want = {k: tuple(v.shape) for k, v in tree_items(jp)}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    assert want["patch_proj"] == (1024, tm.cfg.d_model) and "lm_head.table" in want


def test_patch_proj_moves_no_other_draw():
    """patch_proj is drawn after lm_head and before sig_proj: the dense
    draws of the same shapes, and sig_proj, are the same numbers."""
    cfg = get_config("internvl2-76b").reduced().replace(sig_loss=True)
    vlm = build_model(cfg, seed=4, device="cpu").state_dict()
    dense = build_model(cfg.replace(family="dense"), seed=4, device="cpu").state_dict()
    assert set(vlm) - set(dense) == {"patch_proj"}
    for name, v in dense.items():
        if name != "sig_proj":
            assert torch.equal(vlm[name], v), name
    assert not torch.equal(vlm["sig_proj"], dense["sig_proj"])


def test_full_size_names_shapes_and_count_match_jax():
    """internvl2-76b at full size, stacked 80 deep: the port's initialiser
    under FakeTensorMode (shapes, no storage) against jax.eval_shape of the
    JAX one, 70,562,095,104 parameters (855,654,400 a layer; embed and
    lm_head 1,050,673,152 each, patch_proj 8,388,608, final_norm 8,192)."""
    jcfg, cfg = jget_config("internvl2-76b"), get_config("internvl2-76b")
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in tree_items(shapes)}
    with FakeTensorMode():
        got = {k: tuple(v.shape) for k, v in
               tree_items(init_params(torch.Generator().manual_seed(0), cfg))}
    assert got == want
    count = {k: int(np.prod(s)) for k, s in got.items()}
    assert sum(count.values()) == FULL_COUNT
    per_layer = sum(n for k, n in count.items() if k.startswith("layers.")) // cfg.n_layers
    assert per_layer == 855_654_400
    assert count["embed.table"] == count["lm_head.table"] == 1_050_673_152
    assert count["patch_proj"] == 8_388_608 and count["final_norm.scale"] == 8192
