"""Meshes of ranks for the sharded Gram.

Counterpart of the Gram-mesh half of ``repro.launch``: :func:`gram_mesh_shape`
and :func:`make_gram_mesh`, a ``torch.distributed`` DeviceMesh over the
default process group, and :func:`spawn_ranks`, which starts a local group
(NCCL, one rank a card, or gloo on CPU processes).  The JAX package's
production-pod and simulated-host meshes are XLA's: a gloo group of CPU
processes is the port's simulated mesh.
"""

from .mesh import gram_mesh_shape, make_gram_mesh
from .spawn import spawn_ranks

__all__ = ["gram_mesh_shape", "make_gram_mesh", "spawn_ranks"]
