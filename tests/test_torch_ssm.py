"""The port's Mamba-2 block (``repro_torch.models.ssm``) against the JAX
package's, on the CPU.

The JAX initialiser's parameters (with seeded non-zero ``conv_b``, ``D``,
``dt_bias`` and norm scales, so each counts) and the same numpy inputs go
through both blocks in float32 at the reduced mamba2-780m config (chunk 8,
16 states, heads of 16): ``ssm_apply`` with and without its decode cache at
lengths 1, 2, 3 (below the conv's three-row tail), 13 and 21 (a padded last
chunk) and 16, batch 1 and 3, within 5e-5 relative; its gradients for the
input and every parameter against ``jax.grad`` on a padded chunk within
2e-5 norm-relative, with no NaN; ``ssm_decode`` over several steps, its
cache written in place.  ``ssm_init``'s names, shapes and dtypes are the
JAX initialiser's at the reduced and the full width (14,644,112 parameters
a full-size layer with its norm, 857,846,016 in the whole model), with
``A_log``, ``D`` and ``dt_bias`` within 1e-6.  A prompt whose last chunk is
padded ends in the state (and outputs) of the same prompt at a chunk that
divides it, within 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro.models import ssm as jS
from repro.models import transformer as jT
from repro_torch.models import get_config
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.api import padded_vocab
from repro_torch.models.params import tree_items

VALUE_RTOL = 5e-5      # values and caches, float32
GRAD_RTOL = 2e-5       # gradients, norm-relative
STATE_RTOL = 1e-5      # a padded chunk against one that divides the prompt
INIT_ATOL = 1e-6       # A_log, D, dt_bias


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


def cfgs(**kw):
    return (jget_config("mamba2-780m").reduced().replace(**kw),
            get_config("mamba2-780m").reduced().replace(**kw))


def block_params(seed=0, **kw):
    """(JAX config, port config, JAX parameters, the port's copy): the JAX
    initialiser's draw with seeded non-zero ``conv_b``, ``D``, ``dt_bias``
    and norm scales."""
    jcfg, cfg = cfgs(**kw)
    jp = jS.ssm_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    jp = dict(jp, conv_b=jnp.asarray(f32(rng, *jp["conv_b"].shape, scale=0.1)),
              D=jnp.asarray(1.0 + f32(rng, *jp["D"].shape, scale=0.2)),
              dt_bias=jnp.asarray(jp["dt_bias"] + f32(rng, *jp["dt_bias"].shape, scale=0.3)),
              norm={"scale": jnp.asarray(1.0 + f32(rng, *jp["norm"]["scale"].shape, scale=0.1))})
    tp = jax.tree.map(lambda a: t(a), jp)
    return jcfg, cfg, jp, tp


def assert_cache_close(cache, jcache, rtol=VALUE_RTOL):
    assert set(cache) == set(jcache) == {"conv", "state"}
    for k in cache:
        assert cache[k].dtype == torch.float32 and jcache[k].dtype == jnp.float32, k
        assert rel(cache[k], jcache[k]) <= rtol, k


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("L", [1, 2, 3, 13, 16, 21])
def test_ssm_apply_with_and_without_cache_matches_jax(L, batch):
    jcfg, cfg, jp, tp = block_params()
    u = f32(np.random.default_rng(L), batch, L, cfg.d_model)
    jout, jcache = jS.ssm_apply(jp, u, jcfg, return_cache=True)
    out, cache = S.ssm_apply(tp, t(u), cfg, return_cache=True)
    assert rel(out, jout) <= VALUE_RTOL
    assert rel(S.ssm_apply(tp, t(u), cfg), jout) <= VALUE_RTOL
    assert_cache_close(cache, jcache)
    assert tuple(cache["conv"].shape) == (batch, cfg.ssm_conv - 1, 2 * cfg.d_model + 32)
    if L < cfg.ssm_conv - 1:   # zero rows in front
        assert not cache["conv"][:, :cfg.ssm_conv - 1 - L].any()


@pytest.mark.parametrize("L", [13, 21])
def test_ssm_apply_gradients_match_jax(L):
    """A padded last chunk (13 and 21 at chunk 8): the input's and every
    parameter's gradient of a random projection of the output."""
    jcfg, cfg, jp, tp = block_params(1)
    rng = np.random.default_rng(L + 100)
    u, proj = f32(rng, 2, L, cfg.d_model), f32(rng, 2, L, cfg.d_model)

    def jloss(p, x):
        return jnp.sum(jS.ssm_apply(p, x, jcfg) * proj)

    jg_p, jg_u = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    leaves = dict(tree_items(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    x = t(u).requires_grad_(True)
    loss = (S.ssm_apply(tp, x, cfg) * t(proj)).sum()
    grads = torch.autograd.grad(loss, [x] + list(leaves.values()))
    want = [np.asarray(jg_u)] + [np.asarray(v) for v in
                                 dict(tree_items(jax.tree.map(np.asarray, jg_p))).values()]
    assert list(dict(tree_items(jax.tree.map(np.asarray, jg_p)))) == list(leaves)
    for name, g, w in zip(["u"] + list(leaves), grads, want):
        assert torch.isfinite(g).all(), name
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_RTOL, f"{name}: gradient norm-relative error {err:.3g}"


def test_ssm_decode_matches_jax_and_writes_the_cache_in_place():
    """A prompt of 5, then 7 decode steps, each against JAX's."""
    jcfg, cfg, jp, tp = block_params(2)
    rng = np.random.default_rng(3)
    u = f32(rng, 3, 5, cfg.d_model)
    _, jcache = jS.ssm_apply(jp, u, jcfg, return_cache=True)
    _, cache = S.ssm_apply(tp, t(u), cfg, return_cache=True)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for _ in range(7):
        x = f32(rng, 3, 1, cfg.d_model)
        jout, jcache = jS.ssm_decode(jp, x, jcache, jcfg)
        out, cache2 = S.ssm_decode(tp, t(x), cache, cfg)
        assert cache2 is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
        assert rel(out, jout) <= VALUE_RTOL
        assert_cache_close(cache, jcache)
    assert_cache_close(S.ssm_cache_init(2, cfg), jS.ssm_cache_init(2, jcfg))


def test_ssm_decode_keeps_a_float32_cache_in_bf16_compute():
    _, cfg, _, tp = block_params(4)
    cache = S.ssm_cache_init(2, cfg)
    out, _ = S.ssm_decode(tp, torch.randn(2, 1, cfg.d_model).bfloat16(), cache, cfg)
    assert out.dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    assert cache["conv"].dtype == torch.float32 and cache["state"].abs().sum() > 0


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_ssm_init_matches_jax_names_shapes_and_constants(width):
    jcfg, cfg = (jget_config("mamba2-780m"), get_config("mamba2-780m"))
    if width == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jp = jS.ssm_init(jax.random.PRNGKey(0), jcfg)
    tp = S.ssm_init(torch.Generator().manual_seed(0), cfg)
    want = {k: (v.shape, v.dtype) for k, v in tree_items(jax.tree.map(np.asarray, jp))}
    got = {k: (tuple(v.shape), v.dtype) for k, v in tree_items(tp)}
    assert got.keys() == want.keys()
    for k in got:
        assert got[k][0] == want[k][0] and got[k][1] == torch.float32 == \
            torch.from_numpy(np.zeros(1, want[k][1])).dtype, k
    for k in ("A_log", "D", "dt_bias"):
        assert np.abs(tp[k].numpy() - np.asarray(jp[k])).max() <= INIT_ATOL, k
    assert float(tp["dt_bias"][0]) == pytest.approx(math.log(math.e - 1), abs=1e-7)
    assert not tp["conv_b"].any() and torch.equal(tp["norm"]["scale"], torch.ones(2 * cfg.d_model))


def test_full_size_layer_and_model_counts_match_jax():
    """A full-width ssm layer (its norm included) has the JAX layer's names
    and shapes, 14,644,112 parameters; the model's 48 of them, two untied
    tables of 50,432 × 1536 and the final norm make 857,846,016, the JAX
    initialiser's count (from its shapes alone)."""
    jcfg, cfg = jget_config("mamba2-780m"), get_config("mamba2-780m")
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    jleaves = dict(tree_items(shapes))
    n_jax = sum(math.prod(v.shape) for v in jleaves.values())
    layer = T.layer_init(torch.Generator().manual_seed(0), cfg, T.layer_kind(cfg, 0))
    got = {f"layers.stacked.{k}": (cfg.n_layers,) + tuple(v.shape) for k, v in tree_items(layer)}
    assert got == {k: tuple(v.shape) for k, v in jleaves.items() if k.startswith("layers.")}
    n_layer = sum(v.numel() for _, v in tree_items(layer))
    assert n_layer == 14_644_112
    assert tuple(layer["mixer"]["in_proj"].shape) == (1536, 6448)
    n = cfg.n_layers * n_layer + 2 * padded_vocab(cfg) * cfg.d_model + cfg.d_model
    assert n == n_jax == 857_846_016


@pytest.mark.parametrize("L,padded,divides", [(13, 8, 13), (21, 8, 7), (12, 5, 4)])
def test_padded_chunk_ends_in_the_true_state(L, padded, divides):
    """Padded steps are exact no-ops: the prompt at a chunk that leaves a
    padded last chunk ends in the state (and gives the outputs) of the same
    prompt at a chunk that divides it."""
    _, cfg, _, tp = block_params(5)
    u = t(f32(np.random.default_rng(L), 2, L, cfg.d_model))
    out_a, ca = S.ssm_apply(tp, u, cfg.replace(ssm_chunk=padded), return_cache=True)
    out_b, cb = S.ssm_apply(tp, u, cfg.replace(ssm_chunk=divides), return_cache=True)
    assert L % padded and not L % divides
    assert rel(ca["state"], cb["state"].numpy()) <= STATE_RTOL
    assert torch.equal(ca["conv"], cb["conv"])
    assert rel(out_a, out_b.numpy()) <= STATE_RTOL


def test_ssm_layer_kind_and_cache_follow_jax():
    """The ssm layer is one norm and the mixer (no MLP); its decode cache is
    float32 whatever the compute dtype (the JAX layer cache passes none)."""
    jcfg, cfg = cfgs(compute_dtype="bfloat16")
    assert T.layer_kind(cfg, 1) == jT.layer_kind(jcfg, 1) == "ssm"
    p = T.layer_init(torch.Generator().manual_seed(0), cfg, "ssm")
    assert set(p) == {"ln", "mixer"}
    c = T.layer_cache_init(cfg, "ssm", 2, 10, torch.bfloat16)
    jc = jT.layer_cache_init(jcfg, "ssm", 2, 10, jnp.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in c.items()} == \
        {k: (tuple(v.shape), torch.float32) for k, v in jc.items()}
    assert all(v.dtype == jnp.float32 for v in jc.values())
