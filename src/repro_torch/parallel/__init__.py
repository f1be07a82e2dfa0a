"""Layouts of the sharded Gram across the ranks of a process group.

Counterpart of ``repro.parallel``: the block-cyclic deal of Gram rows and
columns (:func:`block_cyclic_perm`).  The JAX package's PartitionSpec
helpers have no counterpart: the port names its shards by the axes of a
``torch.distributed`` DeviceMesh.
"""

from .sharding import block_cyclic_perm

__all__ = ["block_cyclic_perm"]
