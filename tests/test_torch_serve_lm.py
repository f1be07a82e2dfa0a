"""The port's LM serving path against the JAX package's, on the CPU.

Decode attention (a full KV cache, and a sliding-window ring across its
wrap), the RG-LRU block (``rglru_apply`` with its decode cache at a length
that no chunk divides and below the conv width, ``rglru_decode``), and
``Model.prefill`` / ``cache_init`` / ``decode`` take the same numpy inputs
from a seed in float32, with the JAX initialiser's parameters carried by
:func:`repro_torch.models.params_from_jax`: reduced deepseek-7b in the
stacked and per-layer layouts, reduced recurrentgemma-2b (3 layers,
unrolled) and a 7-layer variant of it in the grouped layout (2 groups of
(rec, rec, attn) and 1 layer after them).  Logits and every cache leaf
agree within 5e-5 relative, the hybrid model's loss too, and its parameter
gradients within 2e-4 norm-relative of ``jax.grad``.  The JAX tests'
prefill-against-decode checks (``tests/test_models.py``) run on the port
at their 2e-4 gate.  ``make_decode_step``: greedy tokens equal JAX's,
sampling is reproducible under a seeded generator and its frequencies pass
a chi-square test against ``softmax(logits / T)``.  The example
``examples/serve_lm_torch.py`` runs from its command line.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.models import attention as jA
from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro.models import rglru as jRG
from repro.serve.step import make_decode_step as jmake_decode_step
from repro_torch.models import build_model, get_config, params_from_jax
from repro_torch.models import attention as A
from repro_torch.models import rglru as RG
from repro_torch.models.params import tree_items
from repro_torch.serve.step import compute_params, make_decode_step, make_prefill_step

ROOT = os.path.join(os.path.dirname(__file__), "..")

VALUE_RTOL = 5e-5      # values: logits, caches, losses (float32)
GRAD_RTOL = 2e-4       # parameter gradients, norm-relative
CONSISTENCY = 2e-4     # tests/test_models.py's prefill-against-decode gate


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: relative error {err:.3g} > {rtol}"


def jax_leaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves}


def assert_caches_close(caches, jcaches, rtol=VALUE_RTOL):
    """Every leaf, by name; integer leaves (ring positions) exactly."""
    got = dict(tree_items(caches))
    want = jax_leaves(jcaches)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w), name
        else:
            assert g.dtype == torch.float32 and w.dtype == np.float32, name
            close(g, w, rtol, name)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def attn_params(rng, n_kv):
    jp = jA.attn_init(jax.random.PRNGKey(int(rng.integers(1 << 30))), 16, 4, n_kv, 8)
    return jp, {k: t(v) for k, v in jp.items()}


@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_decode_attention_full_cache_matches_jax(n_kv):
    rng = np.random.default_rng(0)
    jp, tp = attn_params(rng, n_kv)
    max_len, cur = 9, 5
    cache = {k: f32(rng, 2, max_len, n_kv, 8) for k in ("k", "v")}
    x = f32(rng, 2, 1, 16)
    want, jc = jA.decode_attention(jp, x, {k: jnp.asarray(v) for k, v in cache.items()},
                                   jnp.asarray(cur, jnp.int32), rope_theta=1e4)
    tc = {k: t(v) for k, v in cache.items()}
    got, tc2 = A.decode_attention(tp, t(x), tc, cur, rope_theta=1e4)
    assert tc2 is tc            # updated in place
    close(got, want, VALUE_RTOL, "out")
    for k in ("k", "v"):
        close(tc[k], jc[k], VALUE_RTOL, k)


@pytest.mark.parametrize("n_kv", [2, 1])
def test_decode_attention_window_ring_across_a_wrap_matches_jax(n_kv):
    """A ring of 4 slots from empty through positions 0..10: it wraps at
    position 4 and again at 8; every step's output and cache agree."""
    rng = np.random.default_rng(1)
    jp, tp = attn_params(rng, n_kv)
    window = 4
    jc = jA.window_cache_init(2, window, n_kv, 8, jnp.float32)
    tc = A.window_cache_init(2, window, n_kv, 8, torch.float32)
    assert_caches_close(tc, jc)
    assert tc["pos"].dtype == torch.int32 and int(tc["pos"][0]) == -10 ** 9
    for cur in range(11):
        x = f32(rng, 2, 1, 16)
        want, jc = jA.decode_attention(jp, x, jc, jnp.asarray(cur, jnp.int32),
                                       rope_theta=1e4, window=window)
        got, tc = A.decode_attention(tp, t(x), tc, cur, rope_theta=1e4, window=window)
        close(got, want, VALUE_RTOL, f"out at {cur}")
        assert_caches_close(tc, jc)
    assert sorted(tc["pos"].tolist()) == [7, 8, 9, 10]


def test_decode_attention_keeps_the_cache_dtype_and_accumulates_in_float32():
    """A bf16 cache stays bf16; the scores and the weighted sum are float32
    products of its upcast values (the output rounds to bf16 once)."""
    g = torch.Generator().manual_seed(0)
    p = A.attn_init(g, 16, 4, 2, 8)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    cache = A.cache_init(2, 6, 2, 8, torch.bfloat16)
    cache["k"].normal_(generator=g)
    cache["v"].normal_(generator=g)
    x = torch.randn(2, 1, 16, generator=g).to(torch.bfloat16)
    out, cache = A.decode_attention(p, x, cache, 3, rope_theta=1e4)
    assert out.dtype == cache["k"].dtype == cache["v"].dtype == torch.bfloat16
    # the same arithmetic in float64 from the same rounded operands
    q, k, v = A.qkv(p, x, torch.full((1,), 3), 1e4)
    qf = (q / 8 ** 0.5).to(torch.bfloat16).reshape(2, 2, 2, 8).double()
    s = torch.einsum("bkgd,bckd->bkgc", qf, cache["k"][:, :4].double())
    w = torch.softmax(s, -1).float().to(torch.bfloat16).double()
    o = torch.einsum("bkgc,bckd->bkgd", w, cache["v"][:, :4].double())
    o = o.reshape(2, 1, 4, 8).to(torch.bfloat16)
    want = torch.einsum("bshk,hkd->bsd", o.double(), p["wo"].double())
    assert (out.double() - want).abs().max() <= 2e-2 * want.abs().max()


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def rglru_cfgs():
    return (jget_config("recurrentgemma-2b").reduced(),
            get_config("recurrentgemma-2b").reduced())


def rglru_params(seed=0):
    jcfg, cfg = rglru_cfgs()
    jp = jRG.rglru_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)   # non-zero biases, so they count
    jp = dict(jp, **{b: jnp.asarray(f32(rng, *jp[b].shape, scale=0.1))
                     for b in ("conv_b", "b_a", "b_i")})
    return jcfg, cfg, jp, {k: t(v) for k, v in jp.items()}


@pytest.mark.parametrize("L,chunk", [(11, 4), (13, 64), (2, 4), (1, 64), (16, 4)])
def test_rglru_apply_with_cache_matches_jax(L, chunk):
    """L = 11 and 13: no chunk divides it (padded steps); L = 2 and 1:
    below the conv's three-row tail (zero rows in front)."""
    jcfg, cfg, jp, tp = rglru_params()
    u = f32(np.random.default_rng(L), 2, L, 64)
    jout, jcache = jRG.rglru_apply(jp, u, jcfg, return_cache=True, chunk=chunk)
    out, cache = RG.rglru_apply(tp, t(u), cfg, return_cache=True, chunk=chunk)
    close(out, jout, VALUE_RTOL, "out")
    close(RG.rglru_apply(tp, t(u), cfg, chunk=chunk), jout, VALUE_RTOL, "out, no cache")
    assert_caches_close(cache, jcache)


def test_rglru_decode_matches_jax():
    """Prefill 5 steps, then 6 decode steps, each against JAX's."""
    jcfg, cfg, jp, tp = rglru_params(1)
    rng = np.random.default_rng(2)
    u = f32(rng, 2, 5, 64)
    _, jcache = jRG.rglru_apply(jp, u, jcfg, return_cache=True)
    _, cache = RG.rglru_apply(tp, t(u), cfg, return_cache=True)
    for _ in range(6):
        x = f32(rng, 2, 1, 64)
        jout, jcache = jRG.rglru_decode(jp, x, jcache, jcfg)
        out, cache2 = RG.rglru_decode(tp, t(x), cache, cfg)
        assert cache2 is cache
        close(out, jout, VALUE_RTOL, "out")
        assert_caches_close(cache, jcache)
    z = RG.rglru_cache_init(3, cfg)
    assert_caches_close(z, jRG.rglru_cache_init(3, jcfg))


def test_rglru_init_matches_jax_shapes_and_lambda():
    """The parameters' names and shapes are the JAX initialiser's; Λ is not
    drawn.  JAX computes it in float32 from a float32 linspace, whose half
    ulp (6e-8) near a = 0.999 is 6e-5 of log(a): Λ's own rounding error
    there reaches about 7e-6 of max |Λ|, so the port's float64 value rounded
    once agrees within 1e-5."""
    jcfg, cfg = rglru_cfgs()
    for W in (cfg.lru_width, 2560):
        jp = jRG.rglru_init(jax.random.PRNGKey(0), jcfg.replace(lru_width=W))
        tp = RG.rglru_init(torch.Generator().manual_seed(0), cfg.replace(lru_width=W))
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        close(tp["lam"], jp["lam"], 1e-5, "lam")


# ---------------------------------------------------------------------------
# the models: prefill / cache_init / decode, every layout
# ---------------------------------------------------------------------------

def hybrid_cfg(get, n_layers=None):
    cfg = get("recurrentgemma-2b").reduced()
    if n_layers:   # scanned: 2 (rec, rec, attn) groups and 1 rest layer
        cfg = cfg.replace(n_layers=n_layers, scan_layers=True)
    return cfg


MODELS = {
    "deepseek_layers": lambda get: get("deepseek-7b").reduced(),
    "deepseek_stacked": lambda get: get("deepseek-7b").reduced().replace(scan_layers=True),
    "hybrid_layers": lambda get: hybrid_cfg(get),
    "hybrid_grouped": lambda get: hybrid_cfg(get, 7),
}


def model_pair(which, **replace):
    jcfg, cfg = (MODELS[which](g).replace(**replace) for g in (jget_config, get_config))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return model_pair(request.param)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def test_layouts_carry_the_jax_names(pair):
    jm, jp, tm = pair
    want = {k: v.shape for k, v in jax_leaves(jp).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    cfg = tm.cfg
    if cfg.family == "hybrid" and cfg.scan_layers:
        assert "layers.groups.pos_0.rec.w_x" in want and "layers.layer_6.rec.lam" in want
        assert want["layers.groups.pos_2.attn.wq"][0] == 2


def test_params_from_jax_refuses_the_other_hybrid_layout():
    _, jp, _ = model_pair("hybrid_grouped")
    tm = build_model(hybrid_cfg(get_config, 7).replace(scan_layers=False), device="cpu")
    with pytest.raises(RuntimeError):
        tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))


def test_cache_init_matches_jax(pair):
    jm, jp, tm = pair
    assert_caches_close(tm.cache_init(3, 10), jm.cache_init(jp, 3, 10))


def test_prefill_and_decode_match_jax(pair):
    """Prompt of 6, capacity 16, then 9 decode steps (the hybrid's ring of
    8 wraps at position 8): logits and every cache leaf at each step."""
    jm, jp, tm = pair
    cfg = tm.cfg
    toks = tokens(cfg, 2, 15)
    batch = {"tokens": toks[:, :6], "max_len": 16}
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(batch["tokens"]), "max_len": 16})
    logits, caches = tm.prefill({"tokens": t(batch["tokens"]), "max_len": 16})
    assert logits.shape == (2, 1, 256) and not logits.requires_grad
    close(logits, jl, VALUE_RTOL, "prefill logits")
    assert_caches_close(caches, jc)
    for cur in range(6, 15):
        tok = toks[:, cur:cur + 1]
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.asarray(cur, jnp.int32))
        logits, caches2 = tm.decode(caches, t(tok), cur)
        assert caches2 is caches
        close(logits, jl, VALUE_RTOL, f"decode logits at {cur}")
        assert_caches_close(caches, jc)


def test_decode_takes_a_0d_tensor_position():
    _, _, tm = model_pair("hybrid_layers")
    toks = t(tokens(tm.cfg, 2, 5))
    _, c1 = tm.prefill({"tokens": toks[:, :4], "max_len": 8})
    _, c2 = tm.prefill({"tokens": toks[:, :4], "max_len": 8})
    a, _ = tm.decode(c1, toks[:, 4:], 4)
    b, _ = tm.decode(c2, toks[:, 4:], torch.tensor(4, dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["hybrid_layers", "hybrid_grouped"])
def test_hybrid_loss_and_gradients_match_jax(which):
    jm, jp, tm = model_pair(which, remat=True)
    toks = tokens(tm.cfg, 2, 13, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm.zero_grad()
    loss, met = tm.loss({k: t(v) for k, v in batch.items()})
    loss.backward()
    close(loss, jl, VALUE_RTOL, "loss")
    assert set(met) == set(jmet) == {"ce", "aux"}
    close(met["ce"], jmet["ce"], VALUE_RTOL, "ce")
    want = jax_leaves(jg)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        err = np.linalg.norm(p.grad.numpy() - want[name]) / max(np.linalg.norm(want[name]),
                                                                1e-30)
        assert err <= GRAD_RTOL, f"{name}: gradient norm-relative error {err:.3g}"


# the JAX tests' own consistency checks (tests/test_models.py), on the port

def test_prefill_decode_consistency(pair):
    _, _, tm = pair
    cfg = tm.cfg
    S = 12
    toks = t(tokens(cfg, 2, S, seed=2))
    l_full, _ = tm.prefill({"tokens": toks, "max_len": 32})
    _, cache = tm.prefill({"tokens": toks[:, :S - 1], "max_len": 32})
    l_dec, _ = tm.decode(cache, toks[:, S - 1:], S - 1)
    err = (l_full[..., :cfg.vocab] - l_dec[..., :cfg.vocab]).abs().max()
    assert float(err) < CONSISTENCY, float(err)


@pytest.mark.parametrize("which", ["hybrid_layers", "hybrid_grouped"])
def test_long_recurrent_decode(which):
    """Decode far past the local-attention window (8): prompt 3, 17 steps."""
    _, _, tm = model_pair(which)
    cfg = tm.cfg
    S2 = 20
    toks = t(tokens(cfg, 2, S2, seed=5))
    l_full, _ = tm.prefill({"tokens": toks, "max_len": 64})
    _, cache = tm.prefill({"tokens": toks[:, :3], "max_len": 64})
    for pos in range(3, S2):
        l_dec, cache = tm.decode(cache, toks[:, pos:pos + 1], pos)
    err = (l_full[..., :cfg.vocab] - l_dec[..., :cfg.vocab]).abs().max()
    assert float(err) < CONSISTENCY, float(err)


# ---------------------------------------------------------------------------
# serve/step.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["deepseek_stacked", "hybrid_grouped"])
def test_greedy_decode_step_tokens_equal_jax(which):
    jm, jp, tm = model_pair(which)
    prompt = tokens(tm.cfg, 3, 6, seed=7)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt), "max_len": 20})
    jstep = jmake_decode_step(jm)
    params = compute_params(tm)
    logits, caches = make_prefill_step(tm, max_len=20, params=params)({"tokens": t(prompt)})
    step = make_decode_step(tm, params=params)
    jn = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    for cur in range(6, 19):
        assert np.array_equal(nxt.numpy(), np.asarray(jn)), cur
        jn, jl, jc = jstep(jp, jc, jn, jnp.asarray(cur, jnp.int32))
        nxt, logits, caches = step(caches, nxt, cur)
        assert nxt.dtype == torch.int32 and nxt.shape == (3, 1)
        close(logits, jl, VALUE_RTOL, f"logits at {cur}")


def test_compute_params_share_the_float32_parameters():
    """In float32 compute the step's tree is the parameters themselves: no
    copy of the weights."""
    _, _, tm = model_pair("deepseek_layers")
    p = compute_params(tm)
    assert p["layers"]["layer_0"]["attn"]["wq"] is tm.layers.layer_0.attn.wq
    bf = tm.cfg.replace(compute_dtype="bfloat16")
    tm.cfg = bf
    try:
        q = compute_params(tm)
    finally:
        tm.cfg = MODELS["deepseek_layers"](get_config)
    assert q["layers"]["layer_0"]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("temperature", [0.0, -1.0])
def test_sampling_refuses_a_nonpositive_temperature(temperature):
    _, _, tm = model_pair("deepseek_layers")
    with pytest.raises(ValueError, match="temperature > 0"):
        make_decode_step(tm, greedy=False, temperature=temperature)
    with pytest.raises(ValueError, match="temperature > 0"):
        jmake_decode_step(jbuild_model(MODELS["deepseek_layers"](jget_config)), greedy=False,
                          temperature=temperature)
    make_decode_step(tm, temperature=temperature)   # greedy ignores it


def test_sampling_is_seeded_and_follows_the_softmax():
    """512 copies of one prompt decode one token at T = 1.5, eight times
    from the same position (a full KV cache's slot is rewritten with the
    same values, so the logits repeat): the same seed gives the same
    tokens, and the 4,096 draws' frequencies pass a chi-square test
    against softmax(logits / T) (categories below 5 expected draws
    merged; p > 1e-3)."""
    _, _, tm = model_pair("deepseek_layers")
    T_ = 1.5
    prompt = t(np.repeat(tokens(tm.cfg, 1, 5, seed=9), 512, axis=0))
    logits, caches = make_prefill_step(tm, max_len=8)({"tokens": prompt})
    step = make_decode_step(tm, greedy=False, temperature=T_)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

    def draws(seed, n):
        g = torch.Generator().manual_seed(seed)
        out = []
        for _ in range(n):
            nxt, lg, _ = step(caches, tok, 5, g)
            out.append(nxt)
        return torch.cat(out), lg

    a, lg = draws(11, 8)
    b, _ = draws(11, 8)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert not torch.equal(a, draws(12, 8)[0])
    probs = torch.softmax(lg[0, -1].double() / T_, -1).numpy()
    counts = np.bincount(a.numpy().ravel(), minlength=probs.size)
    assert counts[tm.cfg.vocab:].sum() == 0
    expected = probs * counts.sum()
    big = expected >= 5
    obs, exp = counts[big], expected[big]
    if expected[~big].sum() > 0:
        obs, exp = np.append(obs, counts[~big].sum()), np.append(exp, expected[~big].sum())
    assert big.sum() > 20
    assert scipy.stats.chisquare(obs, exp).pvalue > 1e-3


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def run_example(*args):
    return subprocess.run([sys.executable, "examples/serve_lm_torch.py", "--device", "cpu",
                           *args], capture_output=True, text=True, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": "src"}, timeout=300)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-7b"])
def test_serve_lm_example_runs_on_the_cpu(arch):
    done = run_example("--arch", arch, "--tokens", "8")
    assert done.returncode == 0, done.stdout + done.stderr
    lines = done.stdout.splitlines()
    assert lines[0].startswith(f"arch={arch} generated (4, 8) in ")
    assert lines[1].startswith("sample: [")
    sample = eval(lines[1][len("sample: "):])
    assert len(sample) == 8 and all(0 <= s < 256 for s in sample)


def test_serve_lm_example_refuses_an_unported_family():
    done = run_example("--arch", "mamba2-780m", "--tokens", "2")
    assert done.returncode != 0
    assert "NotImplementedError" in done.stderr and "8b" in done.stderr
