"""The port's model modules against the JAX package's, on the CPU.

The layers (``apply_rope``, ``rmsnorm``, ``layernorm``, ``mlp`` with each
activation, ``blocked_attention`` with a chunk that does not divide the
sequence and grouped KV heads, ``attention``, ``cross_entropy``) take the
same numpy inputs from a seed in float32 and agree within 2e-5 relative.
The reduced deepseek-7b LM with its signature-kernel auxiliary loss and the
example's reduced generator take the JAX package's own initial parameters
through :func:`repro_torch.models.params_from_jax`, in both layer layouts
(``scan_layers`` on: stacked, off: ``layer_{i}``); their losses and metrics
agree within 5e-5 relative and every parameter gradient within 2e-4
norm-relative against ``jax.grad`` (whose signature-kernel backward runs
the ``"reference"`` / ``"antidiag"`` solvers on the CPU).  So do the
reduced MoE LMs (qwen2-moe-a2.7b stacked, dbrx-132b per layer), their
``aux`` metric included, dropless at 24 tokens and with capacity drops at
one group of 256 (the routers ×50, an offset on every embedding row); every
MoE block keeps its router logits off a tie (``tests/test_torch_moe.py``).
So do the reduced mamba2-780m LMs in both layouts, with ``sig_loss`` on
(the JAX tests' own hook test, ``tests/test_models.py``), their 12 tokens
a padded last SSD chunk of 8 and their chunk scans rematerialised.
A stacked build's parameters equal a per-layer build's from the same seed
bit for bit.  The configs are the JAX package's, field for field, and
every assigned config's reduced variant builds.
"""

import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.models import attention as jA
from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro.models import layers as jL
from repro.models import list_configs as jlist_configs
from repro.models.api import _logits as j_logits
from repro.core import losses as jlosses
from repro.core.config import GridConfig as JGrid, TransformPipeline as JPipe
from repro_torch.configs import ASSIGNED
from repro_torch.models import (ParamTree, build_model, get_config, list_configs,
                                params_from_jax)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import _logits, padded_vocab
from repro_torch.models.params import tree_items
from test_torch_moe import assert_margins, record_routing

ROOT = os.path.join(os.path.dirname(__file__), "..")

VALUE_RTOL = 2e-5      # layers, float32
LOSS_RTOL = 5e-5       # whole-model losses and metrics
GRAD_RTOL = 2e-4       # parameter gradients, norm-relative


def load_example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jex = load_example("train_sigkernel_gan")
tex = load_example("train_sigkernel_gan_torch")


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def close(got, want, rtol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def t(a):
    return torch.from_numpy(np.array(a))


def jax_grads_by_name(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves}


def assert_grads_close(module, jgrads, rtol=GRAD_RTOL):
    named = dict(module.named_parameters())
    assert set(named) == set(jgrads)
    for name, p in named.items():
        want = jgrads[name]
        err = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= rtol, f"{name}: gradient norm-relative error {err:.3g} > {rtol}"


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(0)
    x = f32(rng, 2, 7, 3, 16)
    pos = np.arange(7)
    close(L.apply_rope(t(x), t(pos), theta), jL.apply_rope(x, jnp.asarray(pos), theta),
          VALUE_RTOL)
    # positions with a batch axis
    pos2 = np.stack([pos, pos + 5])
    close(L.apply_rope(t(x), t(pos2), theta), jL.apply_rope(x, jnp.asarray(pos2), theta),
          VALUE_RTOL)


def test_norms_match_jax():
    rng = np.random.default_rng(1)
    x = f32(rng, 3, 5, 32)
    p = {"scale": f32(rng, 32), "bias": f32(rng, 32)}
    tp = {k: t(v) for k, v in p.items()}
    close(L.rmsnorm(tp, t(x), 1e-5), jL.rmsnorm(p, x, 1e-5), VALUE_RTOL)
    close(L.layernorm(tp, t(x), 1e-6), jL.layernorm(p, x, 1e-6), VALUE_RTOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(2)
    x = f32(rng, 2, 5, 16)
    jp = jL.mlp_init(jax.random.PRNGKey(3), 16, 24, act)
    tp = {k: t(v) for k, v in jp.items()}
    close(L.mlp(tp, t(x), act), jL.mlp(jp, x, act), VALUE_RTOL)


def test_dtype_policy_follows_the_activations():
    """mlp, qkv and embed cast the weights to the activations' dtype; the
    norms compute in float32 and return the input's dtype."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 16, generator=g).to(torch.bfloat16)
    assert L.mlp(L.mlp_init(g, 16, 24, "silu"), x, "silu").dtype == torch.bfloat16
    assert L.rmsnorm(L.rmsnorm_init(16), x).dtype == torch.bfloat16
    assert L.layernorm(L.layernorm_init(16), x).dtype == torch.bfloat16
    q, k, v = A.qkv(A.attn_init(g, 16, 4, 2, 4), x, torch.arange(5), 1e4)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    assert L.embed(L.embed_init(g, 10, 16), torch.tensor([[1, 2]]), torch.bfloat16).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 4)])
@pytest.mark.parametrize("n_kv", [4, 2, 1])
@pytest.mark.parametrize("chunk", [3, 1024])
def test_blocked_attention_matches_jax(causal, window, n_kv, chunk):
    rng = np.random.default_rng(4)
    q, k, v = f32(rng, 2, 10, 4, 8), f32(rng, 2, 10, n_kv, 8), f32(rng, 2, 10, n_kv, 8)
    pos = np.arange(10)
    kw = dict(causal=causal, window=window, chunk=chunk)
    close(A.blocked_attention(t(q), t(k), t(v), t(pos), t(pos), **kw),
          jA.blocked_attention(q, k, v, jnp.asarray(pos), jnp.asarray(pos), **kw), VALUE_RTOL)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_jax(qkv_bias, cross):
    rng = np.random.default_rng(5)
    jp = jA.attn_init(jax.random.PRNGKey(6), 16, 4, 2, 8, qkv_bias)
    if qkv_bias:   # non-zero biases, so they count
        jp = dict(jp, **{b: jnp.asarray(f32(rng, *jp[b].shape)) for b in ("bq", "bk", "bv")})
    tp = {k: t(v) for k, v in jp.items()}
    x, kv_x = f32(rng, 2, 9, 16), f32(rng, 2, 6, 16)
    pos, kv_pos = np.arange(9), np.arange(6)
    kw = dict(rope_theta=1e4, chunk=4)
    if cross:
        want = jA.attention(jp, x, jnp.asarray(pos), kv_x=kv_x, kv_positions=jnp.asarray(kv_pos),
                            **kw)
        got = A.attention(tp, t(x), t(pos), kv_x=t(kv_x), kv_positions=t(kv_pos), **kw)
    else:
        want = jA.attention(jp, x, jnp.asarray(pos), **kw)
        got = A.attention(tp, t(x), t(pos), **kw)
    close(got, want, VALUE_RTOL)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(7)
    logits = f32(rng, 2, 6, 50, scale=3.0)
    labels = rng.integers(0, 50, size=(2, 6))
    close(L.cross_entropy(t(logits), t(labels), z_loss),
          jL.cross_entropy(logits, jnp.asarray(labels), z_loss), VALUE_RTOL)


def test_padded_vocab_slots_are_masked():
    cfg = get_config("deepseek-7b").reduced().replace(vocab=250)
    jcfg = jget_config("deepseek-7b").reduced().replace(vocab=250)
    assert padded_vocab(cfg) == 256
    rng = np.random.default_rng(8)
    x = f32(rng, 2, 3, 64)
    table = {"table": f32(rng, 256, 64)}
    got = _logits({"embed": {"table": t(table["table"])}}, t(x), cfg)
    want = np.asarray(j_logits({"embed": table}, x, jcfg))
    assert np.all(got[..., 250:].numpy() == -1e30) and np.all(want[..., 250:] == -1e30)
    close(got[..., :250], want[..., :250], VALUE_RTOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_are_the_jax_packages():
    assert ASSIGNED == JAX_ASSIGNED
    assert list_configs() == jlist_configs()
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))
        assert dataclasses.asdict(get_config(name).reduced()) == \
            dataclasses.asdict(jget_config(name).reduced())


@pytest.mark.parametrize("name", ASSIGNED)
def test_every_assigned_config_builds(name):
    cfg = get_config(name).reduced()
    model = build_model(cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert model.cfg is cfg and n > 0
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_build_model_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("deepseek-7b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.build_generator(tex.generator_config(False), 2, 8)


def test_param_tree_round_trips():
    tree = {"a": torch.ones(2, 3), "b": {"c": torch.zeros(4), "d": {"e": torch.ones(1)}}}
    mod = ParamTree(tree)
    assert sorted(mod.state_dict()) == ["a", "b.c", "b.d.e"]
    back = mod.tree()
    assert back["b"]["d"]["e"] is mod.b.d.e
    assert isinstance(back["a"], torch.nn.Parameter)


# ---------------------------------------------------------------------------
# the reduced LM and generator, weights carried across
# ---------------------------------------------------------------------------

B, S = 2, 12
#: the LMs held to JAX: (arch, scan_layers)
LMS = {"layers": ("deepseek-7b", False), "stacked": ("deepseek-7b", True),
       "qwen2_moe_stacked": ("qwen2-moe-a2.7b", True), "dbrx_layers": ("dbrx-132b", False),
       "mamba2_layers": ("mamba2-780m", False), "mamba2_stacked": ("mamba2-780m", True)}


def lm_config(pkg_get, scan, arch="deepseek-7b"):
    return pkg_get(arch).reduced().replace(sig_loss=True, scan_layers=scan, remat=scan)


def lm_batch(cfg, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, seq + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "sig_target": np.cumsum(f32(rng, B, 32, cfg.sig_loss_dim, scale=0.1), axis=1)}


def make_lm_pair(which, edit=None):
    arch, scan = LMS[which]
    jm = jbuild_model(lm_config(jget_config, scan, arch))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if edit:
        jp = edit(jp)
    tm = build_model(lm_config(get_config, scan, arch), device="cpu")
    tm.load_state_dict(params_from_jax(jp))
    return jm, jp, tm


@pytest.fixture(scope="module", params=list(LMS))
def lm_pair(request):
    return make_lm_pair(request.param)


def test_lm_layouts_carry_the_jax_names(lm_pair):
    jm, jp, tm = lm_pair
    names = set(jax_grads_by_name(jp))
    assert set(dict(tm.named_parameters())) == names
    block = "mixer.in_proj" if tm.cfg.family == "ssm" else "attn.wq"
    key = f"layers.stacked.{block}" if tm.cfg.scan_layers else f"layers.layer_1.{block}"
    assert key in names


def test_params_from_jax_refuses_the_other_layout():
    jp = jbuild_model(lm_config(jget_config, True)).init(jax.random.PRNGKey(0))
    tm = build_model(lm_config(get_config, False), device="cpu")
    with pytest.raises(RuntimeError):
        tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))


def loss_and_grads_match_jax(jm, jp, tm, batch):
    """The loss, its metrics and every parameter gradient against JAX's;
    returns the port's routing record (empty for a dense LM)."""
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm.zero_grad()
    with record_routing() as calls:
        loss, met = tm.loss({k: t(v) for k, v in batch.items()})
    loss.backward()
    close(loss, jl, LOSS_RTOL)
    assert set(met) == set(jmet) == {"ce", "aux", "sig"}
    for k in met:
        close(met[k], jmet[k], LOSS_RTOL)
    assert float(met["sig"].detach()) > 0
    assert_grads_close(tm, jax_grads_by_name(jg))
    if tm.cfg.family == "moe":
        assert_margins(calls)
        assert len(calls) == tm.cfg.n_layers and float(met["aux"].detach()) > 0
    else:
        assert not calls and float(met["aux"].detach()) == 0
    return calls


def test_lm_loss_and_gradients_match_jax(lm_pair):
    jm, jp, tm = lm_pair
    loss_and_grads_match_jax(jm, jp, tm, lm_batch(tm.cfg))


def sharpen(jp):
    """Routers ×50 and one offset on every embedding row (a direction all
    tokens share), so that one group of 256 overflows its experts."""
    u = np.random.default_rng(1).normal(size=jp["embed"]["table"].shape[1]) * 0.02
    jp["embed"]["table"] = (jp["embed"]["table"] + u).astype(np.float32)
    layers = jp["layers"]
    for lp in [layers["stacked"]] if "stacked" in layers else layers.values():
        lp["moe"]["router"] = lp["moe"]["router"] * np.float32(50)
    return jp


@pytest.mark.parametrize("which", ["qwen2_moe_stacked", "dbrx_layers"])
def test_moe_lm_loss_and_gradients_with_capacity_drops_match_jax(which):
    """B·S = 2 × 128: one group of 256 tokens, capacity 160 an expert."""
    jm, jp, tm = make_lm_pair(which, sharpen)
    calls = loss_and_grads_match_jax(jm, jp, tm, lm_batch(tm.cfg, seed=2, seq=128))
    assert all(kept < assigned for _, kept, assigned, _ in calls), calls


@pytest.mark.parametrize("which", ["stacked", "qwen2_moe_stacked", "mamba2_stacked",
                                   "hybrid_grouped"])
def test_stacked_build_equals_the_per_layer_draws(which):
    """The stacked (or grouped) build writes each layer's draw into its
    slice as it is drawn: every parameter equals a per-layer build's from
    the same seed, bit for bit, layer by layer."""
    if which == "hybrid_grouped":
        cfg = get_config("recurrentgemma-2b").reduced().replace(n_layers=7)
    else:
        arch, _ = LMS[which]
        cfg = get_config(arch).reduced()
    stacked = build_model(cfg.replace(scan_layers=True), seed=5, device="cpu")
    per_layer = build_model(cfg.replace(scan_layers=False), seed=5, device="cpu")
    assert ("groups" if which == "hybrid_grouped" else "stacked") in stacked.tree()["layers"]
    a = T._layers(stacked.tree()["layers"], stacked.cfg)
    b = T._layers(per_layer.tree()["layers"], per_layer.cfg)
    assert len(a) == len(b) == cfg.n_layers
    for la, lb in zip(a, b):
        pa, pb = dict(tree_items(la)), dict(tree_items(lb))
        assert pa.keys() == pb.keys()
        for name in pa:
            assert torch.equal(pa[name], pb[name]), name
    for name in ("embed.table", "lm_head.table", "final_norm.scale"):
        assert torch.equal(stacked.state_dict()[name], per_layer.state_dict()[name])


def generator_pair(scan):
    jcfg = jget_config("deepseek-7b").reduced().replace(n_layers=2, scan_layers=scan,
                                                        remat=scan)
    cfg = tex.generator_config(False).replace(scan_layers=scan, remat=scan)
    init, apply = jex.build_generator(jcfg, 2, 8)
    jp = init(jax.random.PRNGKey(0))
    gen = tex.build_generator(cfg, 2, 8, device="cpu")
    gen.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    return apply, jp, gen


@pytest.mark.parametrize("dyadic", [0, 1])
@pytest.mark.parametrize("scan", [False, True], ids=["layers", "stacked"])
def test_generator_mmd_and_gradients_match_jax(scan, dyadic):
    """The example's loss: the biased MMD² under time-aug and (λ, λ) =
    (dyadic, dyadic) of generated paths against GBM-like targets."""
    apply, jp, gen = generator_pair(scan)
    rng = np.random.default_rng(9)
    noise = f32(rng, 4, 8, 8)
    real = np.cumsum(f32(rng, 4, 8, 2, scale=0.2), axis=1)

    def jloss(p):
        return jlosses.mmd2(apply(p, noise), real, grid=JGrid(dyadic, dyadic),
                            transforms=JPipe(time_aug=True), unbiased=False)

    jv, jg = jax.value_and_grad(jloss)(jp)
    close(gen(t(noise)), apply(jp, noise), LOSS_RTOL)
    v = tex.losses.mmd2(gen(t(noise)), t(real), **tex.kernel_spec(dyadic))
    v.backward()
    close(v, jv, LOSS_RTOL)
    assert_grads_close(gen, jax_grads_by_name(jg))


def test_generator_paths_are_pinned_at_zero():
    _, _, gen = generator_pair(False)
    out = gen(torch.randn(3, 5, 8))
    assert out.shape == (3, 5, 2)
    assert torch.equal(out[:, 0], torch.zeros(3, 2))


def test_generator_configs_are_the_jax_examples():
    """--full-100m: the JAX example's 12 x 768 backbone (~113M parameters,
    counted from the JAX initialiser's shapes); otherwise its reduced one."""
    base = jget_config("deepseek-7b")
    jfull = base.replace(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                         head_dim=64, vocab=256, scan_layers=True, remat=True,
                         compute_dtype="float32")     # examples/train_sigkernel_gan.py:68-71
    assert dataclasses.asdict(tex.generator_config(True)) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(tex.generator_config(False)) == \
        dataclasses.asdict(base.reduced().replace(n_layers=2))
    shapes = jax.eval_shape(jex.build_generator(jfull, 8, 8)[0], jax.random.PRNGKey(0))
    n = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    assert 110e6 < n < 116e6
