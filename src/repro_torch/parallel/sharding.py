"""The block-cyclic deal of the sharded Gram (pure numpy).

A copy of ``repro.parallel.sharding.block_cyclic_perm``, so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def block_cyclic_perm(n: int, n_shards: int, block: int):
    """Row permutation realising a block-cyclic layout under contiguous sharding.

    Returns ``(perm, inv)`` (numpy int arrays, length ``n``) such that when
    ``x[perm]`` is split into ``n_shards`` equal contiguous pieces, shard
    ``i`` holds the *blocks* ``i, i + n_shards, i + 2·n_shards, …`` of the
    original ``x`` (blocks of ``block`` consecutive rows dealt round-robin,
    ScaLAPACK-style).  ``inv`` undoes it: ``x[perm][inv] == x``.

    ``n`` must be divisible by ``n_shards · block`` (pad first).  The cyclic
    deal keeps a triangular tile grid balanced across shards, where
    contiguous row blocks would give the last shard ~2× the solves of the
    first.
    """
    if n % (n_shards * block) != 0:
        raise ValueError(
            f"block_cyclic_perm needs n divisible by n_shards*block, got "
            f"n={n}, n_shards={n_shards}, block={block}")
    n_blocks = n // block
    # shard i's blocks, concatenated shard by shard
    order = np.arange(n_blocks).reshape(-1, n_shards).T.reshape(-1)
    perm = (order[:, None] * block + np.arange(block)[None, :]).reshape(-1)
    inv = np.argsort(perm)
    return perm, inv
