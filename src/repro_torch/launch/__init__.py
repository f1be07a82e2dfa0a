"""Launching the port: meshes of ranks, local process groups, the input
shape presets, the training driver and the multi-pod dry run.

Counterpart of ``repro.launch``: :func:`gram_mesh_shape` and
:func:`make_gram_mesh`, a ``torch.distributed`` DeviceMesh over the
default process group; :func:`make_production_mesh` (the 16 x 16 pod or
the 2 x 16 x 16 pair of pods) and :func:`make_host_mesh` (1 x 1) over it;
:func:`fake_group`, a default group of n ranks held by one process whose
collectives move nothing; :func:`spawn_ranks`, which starts a local group
(NCCL, one rank a card, or gloo on CPU processes); the shape presets and
input specs (:mod:`repro_torch.launch.shapes`); the training driver
``python -m repro_torch.launch.train`` and its watchdog ``python -m
repro_torch.launch.watchdog``; the dry run ``python -m
repro_torch.launch.dryrun`` (every cell of the sweep laid out over a fake
256- or 512-device mesh: a device's bytes, flops and collectives).  The
JAX package's simulated-host meshes are XLA's: a gloo group of CPU
processes is the port's simulated mesh, a fake group its dry run's.
"""

from .mesh import (fake_group, gram_mesh_shape, make_gram_mesh, make_host_mesh,
                   make_production_mesh)
from .shapes import (SHAPES, SIG_SHAPES, ShapePreset, cache_shape_for, cell_supported,
                     decode_input_specs, microbatch_policy, prefill_input_specs,
                     train_input_specs)
from .spawn import spawn_ranks

__all__ = ["SHAPES", "SIG_SHAPES", "ShapePreset", "cache_shape_for", "cell_supported",
           "decode_input_specs", "fake_group", "gram_mesh_shape", "make_gram_mesh",
           "make_host_mesh", "make_production_mesh", "microbatch_policy",
           "prefill_input_specs", "spawn_ranks", "train_input_specs"]
