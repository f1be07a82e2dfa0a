"""The port's sharded Gram on gloo groups of CPU processes, against the
dense Grams of the port and of the JAX package.

``repro_torch.launch.spawn_ranks`` starts 1, 2, 3 and 4 ranks (meshes
(1, 1), (2, 1), (3, 1), (2, 2)) through ``torch.multiprocessing`` with a
``file://`` store, once a world size, each spawn with a hard timeout; every
rank runs every case of ``tests/torch_sharded_ranks.py`` and returns its
sharded Gram, the port's dense Gram of the same inputs, both pair budgets
and, for the gradient cases, both gradients of ``sum(K * W)``.

Float64 throughout.  Every rank's sharded Gram equals the port's dense Gram
to 1e-12 and the JAX package's dense ``sigkernel_gram`` to 1e-10 (its
``sigkernel_gram_sharded`` does not run on the installed jax: ROADMAP C6);
every rank's gradient equals the dense gradient to 1e-10, so a gradient
``world_size`` times too large fails.  The features cases run on the JAX
package's own draws (made here from its key, as in test_torch_features.py),
which stand in for the port's inside each rank.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
import torch_sharded_ranks as ranks
from repro_torch.launch import gram_mesh_shape, make_gram_mesh, spawn_ranks
from repro_torch.parallel import block_cyclic_perm

jsharding = importlib.import_module("repro.parallel.sharding")
jmesh = importlib.import_module("repro.launch.mesh")

MESHES = {1: (1, 1), 2: (2, 1), 3: (3, 1), 4: (2, 2)}
SPAWN_TIMEOUT = 120


def close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"relative error {err:.3g} > {rtol}"


def jax_feats(case):
    c = ranks.CASES[case]
    return repro.FeatureConfig(c["features"], rank=ranks.FEATURE_RANK[c["features"]],
                               key=jax.random.PRNGKey(3))


def jax_draws(case):
    """The draws the JAX package's dense Gram makes for a features case
    (float64), as numpy: RFF's lift and projections, or Nyström's pool."""
    c = ranks.CASES[case]
    jf = jax_feats(case)
    X = ranks.inputs(case)[0]
    if c["features"] == "nystroem":
        pool = np.asarray(jax.random.permutation(jf.resolved_key(), X.shape[0]))
        return {"pool": pool[:jf.pool_size(X.shape[0])]}
    d = repro.TransformPipeline(**ranks.PIPELINE).transformed_dim(ranks.D) \
        if c.get("transforms") else ranks.D
    k_lift, k_proj = jax.random.split(jf.resolved_key())
    w = b = None
    m = d
    if c.get("kernel") == "rbf":
        kw, kb = jax.random.split(k_lift)
        m = jf.lift_dim
        w = np.asarray(jax.random.normal(kw, (d, m), jnp.float64))
        b = np.asarray(jax.random.uniform(kb, (m,), jnp.float64, 0.0, 2.0 * jnp.pi))
    proj = np.asarray(jax.random.normal(k_proj, (jf.rank, jf.depth, m), jnp.float64))
    return {"w": w, "b": b, "proj": proj}


@pytest.fixture(scope="module")
def jax_side():
    """Every features case's draws, and every value case's dense Gram from
    the JAX package in float64 (exact cases through its serial
    ``"reference"`` scan)."""
    draws, grams = {}, {}
    with jax.enable_x64(True):
        for case, c in ranks.CASES.items():
            X, Y, lengths, lengths_y, _ = ranks.inputs(case)
            kw = ranks.config_kwargs(case, repro)
            if c.get("features"):
                draws[case] = jax_draws(case)
                kw["features"] = jax_feats(case)
            else:
                kw["backend"] = "reference"
            if lengths is not None:
                kw["lengths"] = jnp.asarray(lengths)
                if lengths_y is not None:
                    kw["lengths_y"] = jnp.asarray(lengths_y)
            grams[case] = np.asarray(repro.sigkernel_gram(
                jnp.asarray(X), None if Y is None else jnp.asarray(Y), **kw))
    return draws, grams


@pytest.fixture(scope="module", params=sorted(MESHES), ids=lambda w: f"world{w}")
def gloo_run(request, jax_side):
    """(world size, every rank's results) of one gloo spawn."""
    world = request.param
    return world, spawn_ranks(ranks.gloo_rank, world, (jax_side[0],), backend="gloo",
                              timeout=SPAWN_TIMEOUT)


def padded(B, n_shards, tile=8):
    """Rows after the block-cyclic deal's padding."""
    t = max(1, min(tile, -(-B // n_shards)))
    n_blocks = -(-B // t)
    return (n_blocks + (-n_blocks) % n_shards) * t


# ---------------------------------------------------------------------------
# on every rank of every mesh
# ---------------------------------------------------------------------------

def test_mesh_is_the_near_square_factorisation(gloo_run):
    world, outs = gloo_run
    assert [o["mesh"] for o in outs] == [MESHES[world]] * world


@pytest.mark.parametrize("case", ranks.CASES)
def test_sharded_equals_the_ports_dense_gram(gloo_run, case):
    _, outs = gloo_run
    for o in outs:
        close(o["values"][case]["sharded"], o["values"][case]["dense"], 1e-12)


@pytest.mark.parametrize("case", ranks.CASES)
def test_sharded_matches_the_jax_dense_gram(gloo_run, jax_side, case):
    _, outs = gloo_run
    for o in outs:
        close(o["values"][case]["sharded"], jax_side[1][case], 1e-10)


@pytest.mark.parametrize("gcase", ranks.GRAD_CASES)
def test_every_ranks_gradient_equals_the_dense_gradient(gloo_run, gcase):
    _, outs = gloo_run
    for o in outs:
        got, want = o["grads"][gcase]["sharded_grads"], o["grads"][gcase]["dense_grads"]
        assert set(got) == set(ranks.GRAD_CASES[gcase][1])
        for k in got:
            close(got[k], want[k], 1e-10)


@pytest.mark.parametrize("case", ranks.CASES)
def test_pair_budget_is_the_global_one_on_every_rank(gloo_run, case):
    world, outs = gloo_run
    c = ranks.CASES[case]
    bx = c.get("bx", ranks.BX)
    nd, nm = MESHES[world]
    if c.get("features"):       # the feature maps' own solves, not dealt
        want = [o["values"][case]["dense_pairs"] for o in outs]
    elif c.get("sym"):
        n_pairs = bx * (bx + 1) // 2
        want = [n_pairs + (-n_pairs) % world] * world
        assert want[0] < bx * bx
    else:
        tile = c.get("tile", 8)
        want = [padded(bx, nd, tile) * padded(ranks.BY, nm, tile)] * world
    assert [o["values"][case]["sharded_pairs"] for o in outs] == want


def test_refusals(gloo_run):
    world, outs = gloo_run
    for o in outs:
        msg = o["refusals"]
        assert "start a group of n ranks" in msg["n_not_world"]
        assert "needs an NCCL group" in msg["card_mesh_on_gloo"]
        assert "no 'model' axis" in msg["missing_axis"]
        assert "both 'data'" in msg["same_axis"]


# ---------------------------------------------------------------------------
# the pure-numpy helpers against the JAX package's, and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,block", [(1, 1), (1, 8), (2, 1), (2, 3), (3, 2), (4, 4),
                                            (5, 1)])
@pytest.mark.parametrize("rounds", [1, 3])
def test_block_cyclic_perm_matches_jax(n_shards, block, rounds):
    n = n_shards * block * rounds
    perm, inv = block_cyclic_perm(n, n_shards, block)
    jperm, jinv = jsharding.block_cyclic_perm(n, n_shards, block)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(perm[inv], np.arange(n))


def test_block_cyclic_perm_refuses_a_ragged_deal():
    with pytest.raises(ValueError, match="divisible"):
        block_cyclic_perm(10, 3, 2)


@pytest.mark.parametrize("n", range(1, 17))
def test_gram_mesh_shape_matches_jax(n):
    assert gram_mesh_shape(n) == jmesh.gram_mesh_shape(n)


def test_launch_refusals_without_a_group():
    with pytest.raises(ValueError, match=">= 1"):
        gram_mesh_shape(0)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_gram_mesh()
    with pytest.raises(ValueError, match="backend"):
        spawn_ranks(ranks.sleeping_rank, 1, backend="mpi")
    with pytest.raises(ValueError, match="world"):
        spawn_ranks(ranks.sleeping_rank, 0, backend="gloo")


def test_a_failing_rank_fails_the_group():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        spawn_ranks(ranks.failing_rank, 2, backend="gloo", timeout=60)


def test_a_hung_group_is_ended_at_its_timeout():
    with pytest.raises(TimeoutError):
        spawn_ranks(ranks.sleeping_rank, 2, backend="gloo", timeout=5)
