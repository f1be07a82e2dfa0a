"""Sharding: logical axes, their rules and the layouts of the sharded Gram.

Counterpart of ``repro.parallel``:

* :mod:`.api`: the logical-axis activation sharding API, ``Axis``,
  :data:`DEFAULT_RULES`, :data:`MULTIPOD_RULES`, :func:`current_rules`,
  :func:`logical_rules`, :func:`resolve` and :func:`shard` (the counterpart
  of ``with_sharding_constraint``, the identity outside the rules), with the
  port's own :func:`gather_fsdp` (FSDP's all-gather at use),
  :func:`local_call` (a device's own program, ``local_map``; the counterpart
  of ``shard_map``);
* :mod:`.sharding`: :func:`block_cyclic_perm` (the sharded Gram's deal),
  :func:`gram_specs`, :func:`rules_for`, :func:`logical_spec_for`,
  :func:`physical_spec`, :func:`param_shardings`, :func:`batch_shardings`,
  :func:`replicated`, :func:`cache_shardings` and :func:`placements`, which
  maps a spec (the entries of a JAX ``PartitionSpec``) onto the DTensor
  placements of a ``torch.distributed`` DeviceMesh.
"""

from .api import (DEFAULT_RULES, MULTIPOD_RULES, Axis, current_rules, gather_fsdp,
                  local_call, logical_rules, resolve, shard)
from .sharding import (batch_shardings, block_cyclic_perm, cache_shardings, gram_specs,
                       logical_spec_for, param_shardings, physical_spec, placements,
                       replicated, rules_for)

__all__ = ["Axis", "DEFAULT_RULES", "MULTIPOD_RULES", "batch_shardings", "block_cyclic_perm",
           "cache_shardings", "current_rules", "gather_fsdp", "gram_specs", "local_call",
           "logical_rules", "logical_spec_for", "param_shardings", "physical_spec",
           "placements", "replicated", "resolve", "rules_for", "shard"]
