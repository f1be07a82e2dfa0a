"""The port's int8 gradient compression against the JAX package's, on the
CPU.

``quantize_int8`` and ``dequantize`` are the JAX arithmetic in its order,
so they agree bit for bit: on seeded normals over sixty decades, all
zeros, exact .5 ties (round half to even) and magnitudes near float32's
largest.  The 50-step error-feedback loop of ``tests/test_compression.py``
takes the same values step by step.  ``psum_compressed`` and
``psum_compressed_tree`` run on gloo groups of 1, 2 and 4 processes
(``repro_torch.launch.spawn_ranks``; the ranks' side is
``tests/torch_compression_ranks.py``), held bit for bit to the JAX
``quantize_int8`` / ``dequantize`` of each rank's input, summed over the
ranks in rank order and divided by n: the JAX ``psum_compressed`` itself
raises under ``shard_map`` on jax 0.9 (ROADMAP C3), so it is not the
oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import dequantize as jdequantize
from repro.optim.compression import quantize_int8 as jquantize
from repro_torch.launch import spawn_ranks
from repro_torch.optim import dequantize, init_error_feedback, quantize_int8

import torch_compression_ranks as ranks

jax.config.update("jax_platform_name", "cpu")

SEED = 5


def bits(a) -> bytes:
    a = np.asarray(a)
    return a.dtype.str.encode() + str(a.shape).encode() + a.tobytes()


def jax_quantize(x):
    q, s = jquantize(jnp.asarray(x))
    return np.asarray(q), np.asarray(s), np.asarray(jdequantize(q, s))


def port_quantize(x):
    q, s = quantize_int8(torch.from_numpy(np.asarray(x)))
    return q.numpy(), s.numpy(), dequantize(q, s).numpy()


def inputs():
    rng = np.random.default_rng(0)
    cases = {f"normal_e{e}": (rng.normal(size=(33, 7)) * 10.0 ** e).astype(np.float32)
             for e in range(-30, 31, 6)}
    cases["zeros"] = np.zeros((4, 5), np.float32)
    # max 127 makes the scale 1 (+1e-30 rounds away): every quotient is the
    # input, and the .5s round half to even
    cases["ties"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                             np.float32)
    cases["large"] = np.array([3.0e38, -1.7e38, 1.0e30, 5.0, 0.0], np.float32)
    cases["subnormal_max"] = np.array([1e-40, -3e-41, 0.0], np.float32)
    cases["scalar"] = np.array(-2.75, np.float32)
    # max|x| / 127 rounds otherwise than max|x| · (1 / 127) here
    cases["reciprocal_differs"] = np.array([1.3728498, -0.5, 0.25], np.float32)
    return cases


@pytest.mark.parametrize("case", sorted(inputs()))
def test_quantize_and_dequantize_match_jax_bit_for_bit(case):
    x = inputs()[case]
    q, s, d = port_quantize(x)
    jq, js, jd = jax_quantize(x)
    assert q.dtype == np.int8 and q.shape == x.shape
    assert bits(q) == bits(jq) and bits(s) == bits(js) and bits(d) == bits(jd)
    assert np.abs(d - x).max(initial=0.0) <= float(s) * 0.5 + 1e-6 * max(1.0, float(s))


def test_ties_round_half_to_even():
    q, _, _ = port_quantize(inputs()["ties"])
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126]


def test_error_feedback_loop_matches_jax():
    """tests/test_compression.py::test_error_feedback_unbiased_over_time in
    both packages on the same x: the error and the running sums equal at
    every step, and the running sum of compressed values tracks the true
    one within 1%."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (128,)))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jef, tef = jnp.zeros_like(jx), torch.zeros_like(tx)
    jacc, tacc = jnp.zeros_like(jx), torch.zeros_like(tx)
    jtrue, ttrue = jnp.zeros_like(jx), torch.zeros_like(tx)
    for step in range(50):
        jg, tg = jx + jef, tx + tef
        jq, js = jquantize(jg)
        tq, ts = quantize_int8(tg)
        jdeq, tdeq = jdequantize(jq, js), dequantize(tq, ts)
        jef, tef = jg - jdeq, tg - tdeq
        jtrue, ttrue = jtrue + jx, ttrue + tx
        jacc, tacc = jacc + jdeq, tacc + tdeq
        assert bits(tef.numpy()) == bits(jef), step
        assert bits(tacc.numpy()) == bits(jacc), step
    rel = float((tacc - ttrue).abs().max() / ttrue.abs().max())
    assert rel < 0.01, rel


def test_init_error_feedback_is_float32_zeros():
    ef = init_error_feedback({"a": torch.ones(2, 3, dtype=torch.bfloat16),
                              "b": {"c": torch.ones(4)}})
    assert ef["a"].dtype == ef["b"]["c"].dtype == torch.float32
    assert ef["a"].shape == (2, 3) and not ef["b"]["c"].any()


def jax_mean(xs):
    """The JAX arithmetic of psum_compressed on each rank's x = g + ef:
    (each rank's dequantised int8, stacked in rank order).sum(0) / n, and
    each rank's new error."""
    deq = [jax_quantize(x)[2] for x in xs]
    mean = np.asarray(jnp.stack([jnp.asarray(d) for d in deq]).sum(axis=0) / len(xs))
    return mean, [np.asarray(jnp.asarray(x) - jnp.asarray(d)) for x, d in zip(xs, deq)]


def tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("world", [1, 2, 4])
def test_psum_compressed_on_gloo_matches_jax_arithmetic(world):
    out = spawn_ranks(ranks.compressed_rank, world, args=(SEED,), backend="gloo",
                      timeout=300)
    xs = [ranks.rank_inputs(SEED, r) for r in range(world)]
    # one tensor: g + ef
    mean, efs = jax_mean([(x["g"] + x["ef"]).astype(np.float32) for x in xs])
    for r, got in enumerate(out):
        assert bits(got["mean"]) == bits(mean), r
        assert bits(got["ef"]) == bits(efs[r]), r
    # the tree, two steps from zero error feedback
    ef = [dict(tree_leaves(x["tree"][0])) for x in xs]
    ef = [{k: np.zeros_like(v) for k, v in e.items()} for e in ef]
    for step in range(2):
        grads = [dict(tree_leaves(x["tree"][step])) for x in xs]
        for name in grads[0]:
            m, new = jax_mean([(g[name] + e[name]).astype(np.float32)
                               for g, e in zip(grads, ef)])
            for r, got in enumerate(out):
                got_m, got_ef = (dict(tree_leaves(t)) for t in got["tree_steps"][step])
                assert bits(got_m[name]) == bits(m), (step, name, r)
                assert bits(got_ef[name]) == bits(new[r]), (step, name, r)
            for r in range(world):
                ef[r][name] = new[r]
    # every rank holds the same mean
    for got in out[1:]:
        assert bits(got["mean"]) == bits(out[0]["mean"])
