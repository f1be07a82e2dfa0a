"""The port's mesh path on real values, held to its plain path and to JAX.

Under ``logical_rules`` with DTensor parameters the models take a second
program (``repro_torch.parallel.api``): fsdp gathers, the attention, SSD,
RG-LRU and MoE cores on each device's shards (``local_call``), the
vocab-parallel embedding and cross-entropy, flash-decoding over caches
split along their positions, ring-cache writes, the cross-attention's
decode, the microbatch split and the gradients laid out as their
parameters.  The dry run traces that program on fake tensors; here it runs
on real ones (``tests/torch_mesh_ranks.py``), on a real gloo group of 4
ranks at a 2 x 2 ("data", "model") mesh and of 1 rank at the 1 x 1 host
mesh, every parameter, batch and cache laid out by the port's sharding
rules, for each family's reduced config with the JAX initialiser's
parameters:

* dense: deepseek-7b stacked (KV heads split with the query heads) and
  granite-34b (one KV head, which the model axis cannot split: its caches
  split along their positions and decode by flash-decoding);
* hybrid: recurrentgemma-2b (the RG-LRU scan and its convolution; one KV
  head and a ring of 8 slots, which the 10-token prompt wraps);
* MoE: qwen2-moe-a2.7b (4 experts split over the model axis, a shared
  expert, the load-balance statistics);
* SSM: mamba2-780m (its batch on both axes; the 10-token prompt ends in a
  padded SSD chunk of 8);
* encoder-decoder: whisper-large-v3 (cross K/V in the caches), and a
  variant of it with 3 heads and 15 frames, which the model axis cannot
  split: its self-attention caches split along their positions, its cross
  K/V along the head dim, whose decode sums the scores over that axis;
* VLM: internvl2-76b (4 patch embeddings in place of the first tokens).

For each: the loss, its metrics and every parameter gradient at an
8 x 12 batch; the logits and every cache leaf of a prefill of 10 tokens
into 16 slots and of 3 decode steps after it; the loss and every
parameter after one AdamW step of 2 microbatches.  Gathered whole, each
agrees with the plain path's and with the JAX package's within the
tolerances ``tests/test_torch_serve_lm.py`` holds the plain path to: 5e-5
relative for values (logits, caches, losses; ring positions exactly) and
2e-4 norm-relative for gradients and stepped parameters.  The attention's
key bias (``bk``) is left out of the stepped parameters: its gradient is
zero in exact arithmetic (it shifts all of a query's scores alike), so
AdamW turns the gradient's rounding into an update of either sign.  Every
MoE block the plain path runs keeps its router logits off a tie
(``tests/test_torch_moe.py``).
"""

from __future__ import annotations

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as R
from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro_torch.launch import spawn_ranks
from repro_torch.models import get_config, params_from_jax
from test_torch_moe import assert_margins, record_routing
from test_torch_serve_lm import GRAD_RTOL, VALUE_RTOL, close, frames, jax_leaves

#: name: (arch, config fields replaced in its reduced variant)
CASES = {
    "dense_stacked": ("deepseek-7b", {"scan_layers": True}),
    "dense_one_kv_head": ("granite-34b", {}),
    "hybrid": ("recurrentgemma-2b", {}),
    "moe": ("qwen2-moe-a2.7b", {}),
    "ssm": ("mamba2-780m", {}),
    "encdec": ("whisper-large-v3", {}),
    "encdec_split_head_dim": ("whisper-large-v3",
                              {"n_heads": 3, "n_kv_heads": 3, "n_audio_frames": 15}),
    "vlm": ("internvl2-76b", {}),
}
B_TRAIN, S_TRAIN, B, PROMPT, N_DECODE, MAX_LEN, N_MB = 8, 12, 4, 10, 3, 16, 2
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}


def make_case(name, seed=0):
    """(JAX model, JAX parameters, the case as ``torch_mesh_ranks`` takes it)."""
    arch, replace = CASES[name]
    jcfg = jget_config(arch).reduced().replace(**replace)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch).reduced().replace(**replace)
    state = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jp)).items()}
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B_TRAIN, S_TRAIN + 1)).astype(np.int32)
    prompt = rng.integers(0, cfg.vocab, size=(B, PROMPT + N_DECODE)).astype(np.int32)
    case = {"arch": arch, "replace": replace, "state": state, "max_len": MAX_LEN,
            "n_mb": N_MB,
            "train": {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                      **frames(cfg, B_TRAIN, seed + 1)},
            "prompt": {"tokens": prompt[:, :PROMPT], **frames(cfg, B, seed + 2)},
            "decode": prompt[:, PROMPT:]}
    return jm, jp, case


def jax_outputs(jm, jp, case) -> dict:
    """The JAX package's loss, metrics and gradients, and its prefill and
    decode steps' logits and caches, on the case's inputs (each function
    under ``jax.jit``)."""
    batch = {k: jnp.asarray(v) for k, v in case["train"].items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, batch)
    prompt = {k: jnp.asarray(v) for k, v in case["prompt"].items()}
    logits, caches = jax.jit(lambda p, b: jm.prefill(p, dict(b, max_len=MAX_LEN)))(jp, prompt)
    out = {"loss": loss, "metrics": metrics, "grads": jax_leaves(grads),
           "prefill_logits": logits, "prefill_caches": jax_leaves(caches),
           "decode_logits": []}
    decode = jax.jit(jm.decode)
    for i, tok in enumerate(case["decode"].T):
        logits, caches = decode(jp, caches, jnp.asarray(tok[:, None]),
                                jnp.asarray(PROMPT + i, jnp.int32))
        out["decode_logits"].append(logits)
    out["decode_caches"] = jax_leaves(caches)
    return out


@pytest.fixture(scope="module")
def runs():
    """Both meshes' ranks, started at once; the plain path and JAX here
    meanwhile."""
    built = {name: make_case(name) for name in CASES}
    cases = {name: case for name, (_, _, case) in built.items()}
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {m: pool.submit(spawn_ranks, R.mesh_rank, int(np.prod(shape)),
                                  (cases, shape), backend="gloo", timeout=600)
                   for m, shape in MESHES.items()}
        with record_routing() as calls:
            plain = {name: R.plain_outputs(case) for name, case in cases.items()}
        assert_margins(calls)
        jax_out = {name: jax_outputs(jm, jp, cases[name]) for name, (jm, jp, _) in built.items()}
        mesh = {m: f.result()[0] for m, f in futures.items()}
    return mesh, plain, jax_out


def norm_close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got)), what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, f"{what}: norm-relative error {err:.3g} > {rtol}"


def caches_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), f"{what} {name}"
        else:
            close(g, w, VALUE_RTOL, f"{what} {name}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_path_matches_the_plain_path_and_jax(runs, mesh, name):
    got = runs[0][mesh][name]
    for ref, want in (("plain", runs[1][name]), ("jax", runs[2][name])):
        tag = f"{name} at {mesh} against {ref}:"
        close(got["loss"], want["loss"], VALUE_RTOL, f"{tag} loss")
        assert set(got["metrics"]) == set(want["metrics"]), tag
        for k, v in want["metrics"].items():
            close(got["metrics"][k], v, VALUE_RTOL, f"{tag} metric {k}")
        assert set(got["grads"]) == set(want["grads"]), tag
        for k, v in want["grads"].items():
            norm_close(got["grads"][k], v, GRAD_RTOL, f"{tag} gradient of {k}")
        close(got["prefill_logits"], want["prefill_logits"], VALUE_RTOL, f"{tag} prefill logits")
        caches_close(got["prefill_caches"], want["prefill_caches"], f"{tag} prefill cache")
        for i, (g, w) in enumerate(zip(got["decode_logits"], want["decode_logits"], strict=True)):
            close(g, w, VALUE_RTOL, f"{tag} decode logits at {PROMPT + i}")
        caches_close(got["decode_caches"], want["decode_caches"], f"{tag} decode cache")
    plain = runs[1][name]
    close(got["step_loss"], plain["step_loss"], VALUE_RTOL, f"{name} at {mesh}: step loss")
    for k, v in plain["stepped"].items():
        if not k.endswith("attn.bk"):
            norm_close(got["stepped"][k], v, GRAD_RTOL, f"{name} at {mesh}: stepped {k}")
