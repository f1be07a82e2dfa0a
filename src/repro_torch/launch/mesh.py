"""DeviceMeshes: the (data, model) mesh of the sharded Gram, the production
pods and the host mesh of the dry run, and the fake group it runs on."""

from __future__ import annotations

import contextlib
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


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """A pod of 256 devices, (16, 16) over ``("data", "model")``, or two
    pods, (2, 16, 16) over ``("pod", "data", "model")``, on the default
    process group, which must hold that many ranks (the dry run's
    :func:`fake_group`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cpu"):
    """Degenerate 1 x 1 ``("data", "model")`` mesh over a group of one rank."""
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_group(n: int):
    """A default process group of ``n`` ranks held by this one process as
    rank 0, whose collectives move nothing (torch's ``"fake"`` backend).
    It lets a CPU process lay DTensors out over a 256- or 512-device mesh
    and count the collectives a step would issue; it is destroyed on exit,
    also when the body raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group needs a process without a default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
