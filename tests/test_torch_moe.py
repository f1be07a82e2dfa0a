"""The port's Mixture-of-Experts block against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_apply`` and ``repro.models.moe.moe_apply``
take the same numpy inputs from a seed in float32, with the JAX
initialiser's parameters carried across, on the reduced qwen2-moe-a2.7b
(one shared expert) and dbrx-132b (none) configs: a dropless group of 48
tokens, and one and two groups of 256 tokens with a sharpened router (the
router ×50 and an offset shared by every token), where assignments past an
expert's capacity are dropped.  Values agree within 1e-5 and the auxiliary
loss within 1e-6 relative; the gradients to x and to every parameter,
through ``torch.autograd`` and ``jax.grad``, within 2e-4 norm-relative.
Every case first checks that its inputs keep each token's k+1 largest
router logits apart (``router_margin`` >= 1e-4): ``jax.lax.top_k`` breaks
ties by the lower index and ``torch.topk`` promises nothing, so a near tie
must fail here, not pass as agreement or hide a fault.  The initialiser
keeps the JAX names, shapes and scales; where B·S is past 256 and not a
multiple of it, the reference fails its reshape and the port raises a
``ValueError``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jget_config
from repro.models import moe as jM
from repro_torch.models import get_config
from repro_torch.models import moe as M

VALUE_RTOL = 1e-5
AUX_RTOL = 1e-6
GRAD_RTOL = 2e-4
MARGIN = 1e-4          # least gap between a token's k+1 largest router logits, relative

CONFIGS = ("qwen2-moe-a2.7b", "dbrx-132b")
#: (B, S, router scale, shared offset): dropless; one and two groups of 256
#: whose experts overflow their capacity
CASES = {"dropless": (2, 24, 1.0, False), "one_group": (2, 128, 50.0, True),
         "two_groups": (4, 128, 50.0, True)}


@contextlib.contextmanager
def record_routing():
    """Wrap ``moe.route`` while the block runs: yields a list that gets, for
    every call, its ``router_margin``, kept assignments, assignments and
    each token's chosen experts (sorted)."""
    calls, route = [], M.route

    def recording(p, xg, cfg):
        r = route(p, xg, cfg)
        calls.append((M.router_margin(r.logits, cfg.n_experts_per_tok), float(r.keep.sum()),
                      float(r.onehot.sum()), r.idx.sort(dim=-1).values))
        return r

    M.route = recording
    try:
        yield calls
    finally:
        M.route = route


def assert_margins(calls, margin=MARGIN):
    assert calls, "no MoE block ran"
    least = min(c[0] for c in calls)
    assert least >= margin, f"a near tie in the router logits: {least:.3g} < {margin}"


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def norm_rel(got, want):
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(np.linalg.norm(want), 1e-30)


def by_name(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(by_name(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def block(name, case, seed=0):
    """(jcfg, cfg, JAX params, port params, x, cotangent) of one case."""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    B, S, sharp, offset = CASES[case]
    jp = jM.moe_init(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, router=jp["router"] * sharp)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model))
    if offset:
        x = x + rng.normal(size=(cfg.d_model,))
    cot = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, tp, x.astype(np.float32), cot


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", CONFIGS)
def test_moe_apply_and_gradients_match_jax(name, case):
    jcfg, cfg, jp, tp, x, cot = block(name, case)
    B, S, D = x.shape
    k = cfg.n_experts_per_tok

    def jloss(p, xx):
        y, aux = jM.moe_apply(p, xx, jcfg)
        return jnp.sum(y * cot) + aux

    jy, jaux = jM.moe_apply(jp, x, jcfg)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)

    leaves = {n: v.requires_grad_() for n, v in by_name(tp).items()}
    xt = torch.from_numpy(x).requires_grad_()
    with record_routing() as calls:
        y, aux = M.moe_apply(tp, xt, cfg)
    assert_margins(calls)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32 and aux.ndim == 0
    assert rel(y.detach(), jy) <= VALUE_RTOL
    assert rel(aux.detach(), jaux) <= AUX_RTOL

    r = M.route(tp, xt.detach().reshape(-1, min(M.GROUP, B * S), D), cfg)
    kept = float(r.keep.sum())
    if case == "dropless":
        assert r.cap == B * S and kept == k * B * S
    else:
        assert r.cap == 160 and kept < k * B * S, (r.cap, kept)

    (torch.sum(y * torch.from_numpy(cot)) + aux).backward()
    assert norm_rel(xt.grad, np.asarray(jgx)) <= GRAD_RTOL
    want = {n: np.asarray(v) for n, v in by_name(jgp).items()}
    assert set(leaves) == set(want)
    for n, leaf in leaves.items():
        err = norm_rel(leaf.grad, want[n])
        assert err <= GRAD_RTOL, f"{n}: gradient norm-relative error {err:.3g}"


@pytest.mark.parametrize("name", CONFIGS)
def test_moe_init_matches_jax_names_shapes_and_scales(name):
    """At D = 128, F = 96, E = 8: the JAX names and shapes, and each
    leaf's sample std within 5 standard errors of its scale (0.02 for the
    router and the shared gate, 1/sqrt(fan-in) for the experts)."""
    kw = dict(d_model=128, moe_d_ff=96, n_experts=8)
    jcfg, cfg = jget_config(name).reduced().replace(**kw), get_config(name).reduced().replace(**kw)
    jp = by_name(jM.moe_init(jax.random.PRNGKey(0), jcfg))
    tp = by_name(M.moe_init(torch.Generator().manual_seed(0), cfg))
    assert {n: tuple(v.shape) for n, v in tp.items()} == \
        {n: tuple(v.shape) for n, v in jp.items()}
    assert ("shared.w_up" in tp) == bool(cfg.n_shared_experts)
    D, F = 128, 96
    scales = {"router": 0.02, "w_gate": D ** -0.5, "w_up": D ** -0.5, "w_out": F ** -0.5,
              "shared_gate": 0.02, "shared.w_gate": D ** -0.5, "shared.w_up": D ** -0.5,
              "shared.w_out": (max(cfg.n_shared_experts, 1) * F) ** -0.5}
    for n, v in tp.items():
        assert v.dtype == torch.float32
        std = float(v.std())
        assert abs(std / scales[n] - 1) <= 5 / np.sqrt(2 * v.numel()), (n, std, scales[n])


@pytest.mark.parametrize("B,S", [(3, 100), (1, 300)])
def test_moe_apply_refuses_the_shapes_the_reference_cannot_group(B, S):
    """Past 256 tokens B·S must be a multiple of 256: the reference fails
    its reshape there and the port raises a ValueError naming the rule."""
    jcfg, cfg, jp, tp, _, _ = block("dbrx-132b", "dropless")
    x = np.zeros((B, S, cfg.d_model), np.float32)
    with pytest.raises(TypeError, match="cannot reshape"):
        jM.moe_apply(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="multiple of 256"):
        M.moe_apply(tp, torch.from_numpy(x), cfg)


def test_capacity_follows_the_reference_rule():
    """Dropless up to 128 tokens a group; then 1.25 × g·k/E rounded up to a
    multiple of 4, at least 4."""
    assert M.capacity(4, 4, 60) == 4 and M.capacity(128, 2, 4) == 128
    assert M.capacity(256, 2, 4) == 160          # 160 exactly
    assert M.capacity(256, 4, 60) == 24          # ceil(21.33) = 22 -> 24
    assert M.capacity(256, 4, 16) == 80
    assert M.capacity(129, 1, 256) == 4          # ceil(0.63) = 1 -> 4
