"""The port's logical-axis sharding API (``repro_torch.parallel.api``) held
to the JAX package's (``repro.parallel.api``).

``resolve`` must give the JAX ``PartitionSpec``'s entries for every logical
name and pair of names under the default, multi-pod and SSM rules;
``shard`` is the identity outside ``logical_rules`` and on a plain tensor
inside; ``logical_rules`` nests and restores.  The DTensor cases run on a
fake group of four ranks in this process, destroyed on exit.
"""

from __future__ import annotations

import itertools

import pytest
import torch

from repro.models import get_config as jget_config
from repro.parallel import api as JA
from repro.parallel import sharding as JS
from repro_torch.models import get_config
from repro_torch.parallel import api as TA
from repro_torch.parallel import sharding as TS

NAMES = ["batch", "fsdp", "model", "seq", "residual", "expert", None, "unknown"]


def _rule_sets():
    ssm, jssm = get_config("mamba2-780m"), jget_config("mamba2-780m")
    return {
        "default": (TA.DEFAULT_RULES, JA.DEFAULT_RULES),
        "multipod": (TA.MULTIPOD_RULES, JA.MULTIPOD_RULES),
        "ssm": (TS.rules_for(ssm, False), JS.rules_for(jssm, False)),
        "ssm_multipod": (TS.rules_for(ssm, True), JS.rules_for(jssm, True)),
    }


@pytest.mark.parametrize("rules", sorted(_rule_sets()))
def test_resolve_matches_jax(rules):
    port_rules, jax_rules = _rule_sets()[rules]
    assert port_rules == jax_rules
    combos = [(n,) for n in NAMES] + list(itertools.product(NAMES, repeat=2)) \
        + [("batch", "seq", "model", None), ("batch", "residual", None),
           ("batch", "expert", None, None), ("fsdp", "model", "batch")]
    with TA.logical_rules(port_rules), JA.logical_rules(jax_rules):
        for names in combos:
            assert TA.resolve(*names) == tuple(JA.resolve(*names)), names


def test_resolve_defaults_outside_rules():
    assert TA.current_rules() is None
    assert TA.resolve("batch", "model") == tuple(JA.resolve("batch", "model"))


def test_shard_is_identity_without_a_mesh():
    x = torch.randn(4, 8)
    assert TA.shard(x, "batch", None) is x                 # outside the rules
    with TA.logical_rules(TA.DEFAULT_RULES):
        assert TA.shard(x, "batch", None) is x             # a plain tensor inside
        assert TA.shard(x, "batch") is x                   # and at a wrong rank
    assert TA.gather_fsdp({"w": x})["w"] is x


def test_logical_rules_nest_and_restore():
    assert TA.current_rules() is None
    with TA.logical_rules(TA.DEFAULT_RULES):
        assert TA.current_rules() is TA.DEFAULT_RULES
        with TA.logical_rules(TA.MULTIPOD_RULES):
            assert TA.current_rules() is TA.MULTIPOD_RULES
        assert TA.current_rules() is TA.DEFAULT_RULES
        with pytest.raises(RuntimeError):
            with TA.logical_rules(TA.MULTIPOD_RULES):
                raise RuntimeError("body fails")
        assert TA.current_rules() is TA.DEFAULT_RULES
    assert TA.current_rules() is None


def test_shard_redistributes_a_dtensor():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_group

    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.zeros(4, 6, 8), mesh, [Replicate(), Replicate()])
        assert TA.shard(x, "batch", None, "model") is x    # outside the rules
        with TA.logical_rules(TA.DEFAULT_RULES):
            y = TA.shard(x, "batch", None, "model")
            assert tuple(y.placements) == (Shard(0), Shard(2))
            assert TA.shard(y, "batch", None, "model") is y
            assert TA.shard(x, "batch", None) is x         # rank differs
            z = TA.shard(x, "batch", "model", None)        # 6 rows: model divides
            assert tuple(z.placements) == (Shard(0), Shard(1))
            w = TA.gather_fsdp({"w": distribute_tensor(torch.zeros(4, 8), mesh,
                                                        [Shard(0), Shard(1)])})["w"]
            assert tuple(w.placements) == (Replicate(), Shard(1))
        with TA.logical_rules(TA.MULTIPOD_RULES):
            assert TA.shard(x, "batch", None, None) is x   # the mesh has no "pod"
