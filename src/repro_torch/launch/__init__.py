"""Launching the port: meshes of ranks, local process groups, the input
shape presets and the training driver.

Counterpart of ``repro.launch``: :func:`gram_mesh_shape` and
:func:`make_gram_mesh`, a ``torch.distributed`` DeviceMesh over the
default process group, and :func:`spawn_ranks`, which starts a local group
(NCCL, one rank a card, or gloo on CPU processes); the shape presets and
input specs (:mod:`repro_torch.launch.shapes`); the training driver
``python -m repro_torch.launch.train`` and its watchdog ``python -m
repro_torch.launch.watchdog``.  The JAX package's production-pod and
simulated-host meshes are XLA's: a gloo group of CPU processes is the
port's simulated mesh.
"""

from .mesh import gram_mesh_shape, make_gram_mesh
from .shapes import (SHAPES, SIG_SHAPES, ShapePreset, cache_shape_for, cell_supported,
                     decode_input_specs, microbatch_policy, prefill_input_specs,
                     train_input_specs)
from .spawn import spawn_ranks

__all__ = ["SHAPES", "SIG_SHAPES", "ShapePreset", "cache_shape_for", "cell_supported",
           "decode_input_specs", "gram_mesh_shape", "make_gram_mesh", "microbatch_policy",
           "prefill_input_specs", "spawn_ranks", "train_input_specs"]
