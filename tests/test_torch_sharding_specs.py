"""The port's sharding rules (``repro_torch.parallel.sharding``) held to the
JAX package's (``repro.parallel.sharding``) at full size.

For every name of ``ASSIGNED``, at the 16 x 16 pod and the 2 x 16 x 16
multi-pod mesh, every parameter, AdamW-state, batch and cache leaf must get
the spec JAX's ``physical_spec`` gives it.  The JAX trees come from
``jax.eval_shape`` and its ``NamedSharding``s are built over an
``AbstractMesh`` (no devices); the port's from its initialiser under
``FakeTensorMode`` (nothing allocated), its specs over a plain
``{axis: size}`` mapping.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import shapes as JSHP
from repro.models import build_model as jbuild_model, get_config as jget_config
from repro.optim.adamw import AdamW as JAdamW
from repro.parallel import sharding as JS
from repro_torch.configs import ASSIGNED
from repro_torch.launch import shapes as TSHP
from repro_torch.models import build_model, get_config
from repro_torch.models.params import tree_items, tree_map
from repro_torch.parallel import sharding as TS

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CACHE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_specs(shardings):
    """{dotted path: spec entries} of a tree of NamedShardings."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(
            shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)):
        out[".".join(n.lstrip(".") for n in JS._path_names(path))] = tuple(s.spec)
    return out


def _port_specs(specs):
    return dict(tree_items(specs))


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_leaf_spec_matches_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmodel = jbuild_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jopt = jax.eval_shape(JAdamW(lr=lambda c: 1e-3, moment_dtype=jcfg.moment_dtype).init,
                          jparams)
    jcaches = {s: JSHP.cache_shape_for(jmodel, jcfg, JSHP.SHAPES[s]) for s in CACHE_SHAPES}
    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        params = model.tree()
        mdt = getattr(torch, cfg.moment_dtype)
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=mdt), params)
        opt = {"count": torch.zeros((), dtype=torch.int32), "m": zeros, "v": zeros}
        caches = {s: model.cache_init(TSHP.SHAPES[s].batch, TSHP.SHAPES[s].seq)
                  for s in CACHE_SHAPES}
    jbatches = {"train": JSHP.train_input_specs(jcfg.replace(sig_loss=True),
                                                JSHP.SHAPES["train_4k"]),
                "prefill": JSHP.prefill_input_specs(jcfg, JSHP.SHAPES["prefill_32k"])}
    batches = {"train": TSHP.train_input_specs(cfg.replace(sig_loss=True),
                                               TSHP.SHAPES["train_4k"]),
               "prefill": TSHP.prefill_input_specs(cfg, TSHP.SHAPES["prefill_32k"])}
    checked = 0
    for name, sizes in MESHES.items():
        mp, amesh = "pod" in sizes, _abstract(sizes)
        pairs = [(JS.param_shardings(jparams, jcfg, amesh, mp),
                  TS.param_shardings(params, cfg, sizes, mp)),
                 (JS.param_shardings(jopt, jcfg, amesh, mp),
                  TS.param_shardings(opt, cfg, sizes, mp))]
        pairs += [(JS.batch_shardings(jbatches[k], jcfg, amesh, mp),
                   TS.batch_shardings(batches[k], cfg, sizes, mp)) for k in batches]
        pairs += [(JS.cache_shardings(jcaches[s], jcfg, amesh, mp),
                   TS.cache_shardings(caches[s], cfg, sizes, mp)) for s in CACHE_SHAPES]
        for jtree, ttree in pairs:
            want, got = _jax_specs(jtree), _port_specs(ttree)
            assert set(got) == set(want), (name, set(got) ^ set(want))
            for path, spec in want.items():
                assert got[path] == spec, (arch, name, path, got[path], spec)
                checked += 1
    assert checked > 40


@pytest.mark.parametrize("sizes", list(MESHES.values()), ids=list(MESHES))
def test_gram_specs_match_jax(sizes):
    jmesh = SimpleNamespace(shape=sizes)
    for Bx, By in ((4096, 4096), (512, 512), (100, 48), (3, 7), (32, 256)):
        want = tuple(tuple(s) for s in JS.gram_specs(jmesh, Bx, By))
        assert TS.gram_specs(sizes, Bx, By) == want, (Bx, By)
        if "pod" in sizes:
            want = tuple(tuple(s) for s in JS.gram_specs(jmesh, Bx, By, row_axis="pod"))
            assert TS.gram_specs(sizes, Bx, By, row_axis="pod") == want


def test_placements_round_trip():
    from torch.distributed.tensor import Replicate, Shard
    sizes = MESHES["2x16x16"]
    specs = [(), (None,), ("data",), (("pod", "data"), None, "model"),
             (None, ("pod", "data", "model")), ("model", ("pod", "data")),
             (None, None, None, "model"), (("data", "model"), None)]
    for spec in specs:
        pl = TS.placements(spec, sizes)
        assert len(pl) == 3
        ndim = max(len(spec), 1)
        assert TS.spec_of(pl, sizes, ndim) == _pad(spec, ndim)
    assert TS.placements((("pod", "data"), "model"), sizes) == (Shard(0), Shard(0), Shard(1))
    assert TS.placements((None,), sizes) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        TS.placements((("model", "data"),), sizes)       # not the mesh's order
    with pytest.raises(ValueError):
        TS.placements(("data", "data"), sizes)           # one axis twice


def test_local_shape_of_a_spec():
    sizes = MESHES["2x16x16"]
    assert TS.local_shape((4096, 64, 128), (("pod", "data"), "model", None), sizes) == \
        (128, 4, 128)
    assert TS.local_shape((7,), (None,), sizes) == (7,)
