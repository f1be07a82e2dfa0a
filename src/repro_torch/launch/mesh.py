"""The (data, model) DeviceMesh of the sharded Gram."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def gram_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Near-square ``(data, model)`` factorisation of ``n_devices``.

    The Gram engine tiles rows over ``data`` and columns over ``model``; a
    square-ish mesh minimises the prepared-stream rows each rank solves
    against.  The larger factor goes to ``data``.  1 -> (1, 1),
    4 -> (2, 2), 8 -> (4, 2), 12 -> (4, 3), primes -> (p, 1).
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    best = 1
    for f in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % f == 0:
            best = f
    return (n_devices // best, best)


def make_gram_mesh(n: Optional[int] = None, *, device_type: Optional[str] = None,
                   axis_names: Tuple[str, str] = ("data", "model")):
    """A ``(data, model)`` DeviceMesh over the default process group, shaped
    by :func:`gram_mesh_shape`.

    Call it on every rank after ``torch.distributed.init_process_group``.
    ``n`` defaults to the world size and may be nothing else: one process
    drives one device, so a mesh cannot leave out ranks of the group (the
    JAX package's sub-meshes over a subset of one process's devices have no
    counterpart).  ``device_type`` defaults to ``"cuda"`` when the group's
    backend is NCCL, else ``"cpu"``; a card mesh on a group without NCCL is
    refused (gloo would move card tensors through the host).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_gram_mesh needs torch.distributed.init_process_group "
                           "to have run on every rank")
    world = dist.get_world_size()
    if n is None:
        n = world
    if n != world:
        raise ValueError(
            f"make_gram_mesh(n={n}) over a group of {world} ranks: the mesh spans the "
            "whole default group, one rank a device; start a group of n ranks instead")
    nccl = "nccl" in dist.get_backend()
    if device_type is None:
        device_type = "cuda" if nccl else "cpu"
    if device_type == "cuda" and not nccl:
        raise ValueError(f"a card mesh needs an NCCL group, this one is "
                         f"{dist.get_backend()!r}: gloo moves card tensors through the host")
    return init_device_mesh(device_type, gram_mesh_shape(n),
                            mesh_dim_names=tuple(axis_names))
