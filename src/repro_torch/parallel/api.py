"""Mesh-context helpers: logical-axis activation sharding.

Counterpart of ``repro/parallel/api.py``.  Models annotate activations with
*logical* axis names; the mapping onto the axes of a ``torch.distributed``
DeviceMesh is installed by the launcher (the dry run,
:mod:`repro_torch.launch.dryrun`).  Outside any rules context the
annotations are the identity (:func:`shard` returns its argument itself),
so the same model code runs on one card and over a 512-device mesh.

A spec is a tuple with one entry a tensor dim, each ``None``, a mesh axis
name or a tuple of names: the entries JAX's ``PartitionSpec`` holds.
:func:`repro_torch.parallel.sharding.placements` maps one onto DTensor
placements.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

_state = threading.local()

# default logical -> physical mapping for a ("data", "model") mesh
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": "data",            # data-parallel batch
    "fsdp": "data",             # parameter/optimizer sharding axis
    "model": "model",           # tensor-parallel axis
    "seq": None,                # sequence axis inside layers
    "residual": "model",        # sequence axis of the residual stream (SP):
                                # shards remat-saved carries and turns TP
                                # all-reduces into reduce-scatter/all-gather
    "expert": "model",          # expert-parallel axis
    None: None,
}

MULTIPOD_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "model": "model",
    "seq": None,
    "residual": "model",
    "expert": "model",
    None: None,
}


def current_rules() -> Optional[Dict[str, Axis]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: Dict[str, Axis]):
    """Install ``rules`` for this thread; the previous rules come back on
    exit, also when the body raises."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def resolve(*logical: Optional[str]) -> Spec:
    """Logical axis names -> spec under the active rules.

    Deduplicates mesh axes left to right (a mesh axis may appear in at most
    one positional dim, e.g. mamba2 maps both ``batch`` and ``model`` onto
    the model axis; the first dim wins)."""
    rules = current_rules() or DEFAULT_RULES
    out, used = [], set()
    for name in logical:
        axis = rules.get(name, None)
        axes = (axis,) if isinstance(axis, str) else tuple(axis or ())
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(out)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The counterpart of ``with_sharding_constraint`` by logical axis names.

    Outside :func:`logical_rules` it returns ``x`` itself.  Inside, a
    DTensor is redistributed to the placements the names resolve to on its
    own mesh; a plain tensor (one device, eager) is returned as it is, and
    so is a DTensor whose rank differs from the names' count or whose mesh
    lacks a resolved axis (where the JAX function's ``except`` leaves the
    array unconstrained).  A mesh axis that does not divide its dim is
    dropped from it, as :func:`repro_torch.parallel.sharding.physical_spec`
    drops it (XLA pads such a dim instead; DTensor's shards stay even).
    The gradient that flows back through the call is laid out alike."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or x.ndim != len(logical):
        return x
    mesh = x.device_mesh
    names = set(mesh.mesh_dim_names or ())
    if any(a not in names for e in resolve(*logical) if e is not None
           for a in ((e,) if isinstance(e, str) else e)):
        return x
    target = layout(logical, x.shape, mesh)
    if tuple(x.placements) != target:
        x = x.redistribute(mesh, target)
    if x.requires_grad:   # the cotangent takes the layout too, as JAX's transpose does
        x = _CotangentLayout.apply(x, target)
    return x


class _CotangentLayout(torch.autograd.Function):
    """The identity; its backward lays the gradient out as ``placements``
    (a partial sum reduced), as the cotangent of JAX's
    ``with_sharding_constraint`` is constrained alike."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def layout(logical, shape, mesh) -> Tuple:
    """The DTensor placements on ``mesh`` of a tensor of ``shape`` whose dims
    carry the ``logical`` names, under the active rules (the default ones
    outside :func:`logical_rules`)."""
    from .sharding import physical_spec, placements
    return placements(physical_spec(tuple(logical), shape, mesh,
                                    current_rules() or DEFAULT_RULES), mesh)


def local_call(fn, args, in_logical, out_logical, out_shapes):
    """``fn(*args)`` run on each device's shards: the point where a device's
    own program begins (``torch.distributed.tensor.experimental.local_map``,
    the counterpart of ``shard_map``).

    ``in_logical[i]`` names the dims of DTensor ``args[i]``, which is
    redistributed to that layout first (``...``: a DTensor taken as it is
    laid out, e.g. a cache that ``fn`` writes in place; ``None``: an
    argument handed over as it is, a plain tensor every device holds whole,
    or a non-tensor);
    ``out_logical[j]`` names the dims of output ``j``, of global shape
    ``out_shapes[j]`` (or is a list: its placements themselves, e.g. a
    partial sum).  ``fn`` sees local tensors and returns a tensor or a
    tuple of them, each this device's shard of its output.

    The gradient of an argument that a mesh axis holds whole, where that
    axis splits the work (an argument or an output is split or partial on
    it), is the sum of each device's share along it: a partial sum.  So
    ``fn``'s outputs on such an axis are each device's own, or shares that
    sum to the whole."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    in_pl = tuple(None if (n is None or not isinstance(a, DTensor)) else
                  tuple(a.placements) if n is ... else layout(n, a.shape, mesh)
                  for n, a in zip(in_logical, args))
    args = tuple(a.redistribute(mesh, p) if p is not None and tuple(a.placements) != p else a
                 for a, p in zip(args, in_pl))
    out_pl = tuple(tuple(n) if isinstance(n, list) else layout(n, s, mesh)
                   for n, s in zip(out_logical, out_shapes))
    split = {d for d in range(mesh.ndim)
             if any(p is not None and p[d].is_shard() for p in in_pl)
             or any(p[d].is_shard() or p[d].is_partial() for p in out_pl)}
    grad_pl = tuple(None if p is None else
                    [Partial() if d in split and q.is_replicate() else q for d, q in enumerate(p)]
                    for p in in_pl)
    # local_map reads a tuple as one entry an output, a list as one output
    outs = tuple(list(p) for p in out_pl)
    wrapped = local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                        in_placements=tuple(None if p is None else list(p) for p in in_pl),
                        in_grad_placements=grad_pl, device_mesh=mesh)
    return wrapped(*args)


def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor under installed rules: the test that
    selects a model's mesh path (never taken outside :func:`logical_rules`)."""
    if current_rules() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def gather_fsdp(tree):
    """FSDP's all-gather at use: every DTensor leaf of ``tree`` (a nested
    dict) with its shards on the active rules' ``fsdp`` axes replicated
    over those axes, its other placements kept (the tensor-parallel
    shards).  This is the gather XLA makes where a weight sharded over its
    d_model dim meets a batch-sharded activation; its backward is the
    gradients' reduce-scatter.  The identity outside :func:`logical_rules`
    and on plain tensors."""
    rules = current_rules()
    if rules is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate
    axis = rules.get("fsdp")
    axes = (axis,) if isinstance(axis, str) else tuple(axis or ())

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        new = tuple(Replicate() if (n in axes and p.is_shard()) else p
                    for n, p in zip(names, t.placements))
        return t if new == tuple(t.placements) else t.redistribute(t.device_mesh, new)

    return one(tree)


def write_local(dst, src, dim: Optional[int] = None, start: int = 0) -> None:
    """In place on a mesh: ``dst`` (a DTensor) takes ``src``, or its
    positions ``[start, start + n)`` along ``dim`` do (``n = src.shape[dim]``),
    each device writing its own shard (where ``dim`` is sharded, the part of
    those positions its slice holds).  ``src`` is first laid out as ``dst``
    is, whole along ``dim``."""
    from torch.distributed.tensor import Replicate
    if dim is None or src.shape[dim] == dst.shape[dim]:
        src = src.to(dst.dtype).redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
        return
    mesh = dst.device_mesh
    axes = [i for i, p in enumerate(dst.placements) if p.is_shard(dim)]
    whole = [Replicate() if i in axes else p for i, p in enumerate(dst.placements)]
    d = dst.to_local()
    s = src.to(dst.dtype).redistribute(mesh, whole).to_local()
    lo = shard_index(mesh, axes) * d.shape[dim] if axes else 0
    a, b = max(start, lo), min(start + s.shape[dim], lo + d.shape[dim])
    if a < b:
        d.narrow(dim, a - lo, b - a).copy_(s.narrow(dim, a - start, b - a))


class _Psum(torch.autograd.Function):
    """An all-reduce over mesh axes inside a device's program; its backward
    hands the (replicated) gradient on unchanged, as each device's share
    enters the sum once."""

    @staticmethod
    def forward(ctx, t, mesh, axes, op):
        from torch.distributed import _functional_collectives as funcol
        for a in axes:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, a)))
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def psum(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``t`` (a local tensor) reduced by ``op`` over the mesh ``axes``
    (indices into ``mesh``'s dims), inside a device's own program
    (:func:`local_call`): the functional all-reduce each axis, which
    ``CommDebugMode`` counts.  Differentiable for ``op="sum"``, whose
    result every device of the axes then holds and uses alike."""
    return _Psum.apply(t, mesh, tuple(axes), op)


def shard_index(mesh, axes) -> int:
    """This device's index among the shards that mesh ``axes`` (indices, a
    dim split over them major first) cut a dim into."""
    c = mesh.get_coordinate()
    i = 0
    for a in axes:
        i = i * mesh.size(a) + c[a]
    return i
