"""The port's encoder-decoder (``repro_torch.models.whisper`` and
``EncDecModel``) against the JAX package's, on the CPU.

The JAX initialiser's parameters, carried across by
:func:`repro_torch.models.params_from_jax`, and the same numpy inputs from a
seed go through both in float32 at the reduced whisper-large-v3 config (2
encoder and 2 decoder layers of width 64), per layer and stacked.  The
sinusoid's frequencies equal the JAX package's bit for bit (its float32
``exp`` as XLA's CPU backend computes it) and the embeddings agree within
1e-6 absolute at positions up to 1,499.  The encoder at 16 and at 1,500
frames (a padded last KV chunk of 1,024: 548 masked slots), the loss with
``sig_loss`` on (5e-5 relative), and every parameter's gradient and the
frames' gradient against ``jax.grad`` (2e-4 norm-relative), at 16 and
1,500 frames; prefill and decode over 1,500 frames, logits and every cache
leaf (5e-5).  At full size, the parameters' names and shapes and their
count, 1,954,370,560, are the JAX initialiser's (from ``jax.eval_shape``),
counted from one full-width layer of each stack.  ``tests/test_torch_serve_lm.py``
holds the serving methods at 16 frames with the other families.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro.models import whisper as jW
from repro_torch.models import build_model, get_config, params_from_jax
from repro_torch.models import whisper as W
from repro_torch.models.api import EncDecModel, padded_vocab
from repro_torch.models.params import tree_items

SIN_ATOL = 1e-6        # the sinusoid, absolute
VALUE_RTOL = 5e-5      # encoder states, losses, logits and caches
GRAD_RTOL = 2e-4       # gradients, norm-relative
LAYOUTS = {"layers": False, "stacked": True}


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


def cfgs(scan, **kw):
    """(JAX config, port config): reduced whisper-large-v3 in a layout,
    rematerialised where stacked."""
    return tuple(get("whisper-large-v3").reduced().replace(scan_layers=scan, remat=scan, **kw)
                 for get in (jget_config, get_config))


def pair(scan, **kw):
    jcfg, cfg = cfgs(scan, **kw)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jp))
    return jm, jp, tm


def frames(cfg, B, F, seed=0):
    return (0.1 * np.random.default_rng(seed).normal(size=(B, F, cfg.d_model))).astype(np.float32)


# ---------------------------------------------------------------------------
# the sinusoid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 64, 1280, 4096])
def test_frequencies_equal_jax_bit_for_bit(d):
    half = d // 2
    want = np.asarray(jnp.exp(-math.log(10000.0) * jnp.arange(half) / max(half - 1, 1)))
    got = W._freqs(d, torch.device("cpu")).numpy()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoid_matches_jax(d):
    pos = np.arange(1500)
    got = W.sinusoid(t(pos), d, torch.float32)
    want = np.asarray(jW.sinusoid(jnp.asarray(pos), d, jnp.float32))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1500, d)
    assert float(np.abs(got.numpy() - want).max()) <= SIN_ATOL
    assert W.sinusoid(t(pos[:5]), d, torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the encoder, the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("F", [16, 1500])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_encoder_matches_jax(layout, F):
    jm, jp, tm = pair(LAYOUTS[layout])
    fr = frames(tm.cfg, 2, F, seed=F)
    want = np.asarray(jW.encoder_apply(jp["enc"], jnp.asarray(fr), jm.cfg))
    got = W.encoder_apply(tm.tree()["enc"], t(fr), tm.cfg)
    assert rel(got, want) <= VALUE_RTOL


@pytest.mark.parametrize("F", [16, 1500])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_and_gradients_match_jax(layout, F):
    """sig_loss on; every parameter's gradient and the frames'."""
    jm, jp, tm = pair(LAYOUTS[layout], sig_loss=True)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 13))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "sig_target": np.cumsum(f32(rng, 2, 32, cfg.sig_loss_dim, scale=0.1), axis=1)}
    fr = frames(cfg, 2, F, seed=2)

    def jloss(p, x):
        return jm.loss(p, {**{k: jnp.asarray(v) for k, v in batch.items()}, "frames": x})

    (jl, jmet), (jg, jgf) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(fr))
    x = t(fr).requires_grad_()
    loss, met = tm.loss({**{k: t(v) for k, v in batch.items()}, "frames": x})
    loss.backward()
    assert rel(loss, jl) <= VALUE_RTOL
    assert set(met) == set(jmet) == {"ce", "sig"}
    for k in met:
        assert rel(met[k], jmet[k]) <= VALUE_RTOL, k
    want = dict(tree_items(jax.tree.map(np.asarray, jg)))
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert norm_rel(p.grad.numpy(), want[name]) <= GRAD_RTOL, name
    assert norm_rel(x.grad.numpy(), np.asarray(jgf)) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# serving over 1,500 frames: the cross-attention's padded chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_and_decode_over_1500_frames_match_jax(layout):
    jm, jp, tm = pair(LAYOUTS[layout], n_audio_frames=1500)
    cfg = tm.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 10)).astype(np.int32)
    fr = frames(cfg, 2, 1500, seed=4)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :6]), "frames": jnp.asarray(fr),
                             "max_len": 12})
    logits, caches = tm.prefill({"tokens": t(toks[:, :6]), "frames": t(fr), "max_len": 12})
    V = cfg.vocab
    assert rel(logits[..., :V], np.asarray(jl)[..., :V]) <= VALUE_RTOL
    for cur in range(6, 10):
        jl, jc = jm.decode(jp, jc, jnp.asarray(toks[:, cur:cur + 1]),
                           jnp.asarray(cur, jnp.int32))
        logits, caches = tm.decode(caches, t(toks[:, cur:cur + 1]), cur)
        assert rel(logits[..., :V], np.asarray(jl)[..., :V]) <= VALUE_RTOL, cur
    want = dict(tree_items(jax.tree.map(np.asarray, jc)))
    got = dict(tree_items(caches))
    assert set(got) == set(want)
    for name, v in got.items():
        assert v.shape[-3] == (1500 if name.endswith(("ck", "cv")) else 12), name
        assert rel(v, want[name]) <= VALUE_RTOL, name


def test_prefill_refuses_a_prompt_past_max_len():
    _, _, tm = pair(False)
    fr = t(frames(tm.cfg, 1, 16))
    with pytest.raises(ValueError, match="does not fit a KV cache of 4 slots"):
        tm.prefill({"tokens": torch.zeros((1, 5), dtype=torch.int64), "frames": fr,
                    "max_len": 4})


# ---------------------------------------------------------------------------
# the builds
# ---------------------------------------------------------------------------

def test_stacked_build_equals_the_per_layer_draws():
    """The stacked build writes each layer's draw into its slice: every
    parameter equals a per-layer build's from the same seed, bit for bit."""
    cfg = get_config("whisper-large-v3").reduced()
    stacked = build_model(cfg.replace(scan_layers=True), seed=5, device="cpu")
    per_layer = build_model(cfg, seed=5, device="cpu")
    assert isinstance(stacked, EncDecModel)
    s, p = stacked.state_dict(), per_layer.state_dict()
    for stack, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
        names = [k for k in s if k.startswith(f"{stack}.stacked.")]
        assert names
        for name in names:
            assert s[name].shape[0] == n
            for i in range(n):
                other = name.replace(f"{stack}.stacked.", f"{stack}.layer_{i}.")
                assert torch.equal(s[name][i], p[other]), (name, i)
    for name in ("embed.table", "ln_enc.scale", "ln_out.bias"):
        assert torch.equal(s[name], p[name])
    assert "lm_head.table" not in s


def test_full_size_names_shapes_and_count_match_jax():
    """One full-width layer of each stack (stacked 32 deep), the tied table
    of 51,968 × 1280 and the two final norms: the JAX initialiser's names and
    shapes, 1,954,370,560 parameters."""
    jcfg, cfg = jget_config("whisper-large-v3"), get_config("whisper-large-v3")
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    jleaves = {k: tuple(v.shape) for k, v in tree_items(shapes)}
    n_jax = sum(math.prod(s) for s in jleaves.values())
    g = torch.Generator().manual_seed(0)
    enc, dec = W.enc_layer_init(g, cfg), W.dec_layer_init(g, cfg)
    got = {f"enc.stacked.{k}": (cfg.n_enc_layers,) + tuple(v.shape) for k, v in tree_items(enc)}
    got.update({f"dec.stacked.{k}": (cfg.n_layers,) + tuple(v.shape)
                for k, v in tree_items(dec)})
    vp, d = padded_vocab(cfg), cfg.d_model
    got.update({"embed.table": (vp, d), "ln_enc.scale": (d,), "ln_enc.bias": (d,),
                "ln_out.scale": (d,), "ln_out.bias": (d,)})
    assert got == jleaves
    small = W.init(torch.Generator().manual_seed(0), cfg.reduced().replace(vocab=vp))
    assert set(small) == {k.split(".")[0] for k in jleaves}
    n = (cfg.n_enc_layers * sum(v.numel() for _, v in tree_items(enc))
         + cfg.n_layers * sum(v.numel() for _, v in tree_items(dec)) + vp * d + 4 * d)
    assert n == n_jax == 1_954_370_560
