"""Sharding layouts: the block-cyclic deal of the sharded Gram and the
parameter, batch, cache and Gram specs of the dry run.

A copy of ``repro/parallel/sharding.py``, so that the port imports nothing
of the JAX package: :func:`block_cyclic_perm` (pure numpy), :func:`gram_specs`,
the rule tables, :func:`rules_for`, :func:`logical_spec_for`,
:func:`physical_spec`, :func:`param_shardings`, :func:`batch_shardings`,
:func:`replicated` and :func:`cache_shardings`, with the JAX names.  Where
the JAX helpers build ``NamedSharding``s, these give specs (tuples, the
entries of a ``PartitionSpec``), and :func:`placements` maps a spec onto a
DeviceMesh's DTensor placements.  ``get_shard_map`` has no counterpart:
``torch.distributed.tensor.experimental.local_map`` takes its place.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .api import DEFAULT_RULES, MULTIPOD_RULES, Axis, Spec


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


# ---------------------------------------------------------------------------
# parameter, batch and cache specs: tree-path pattern -> logical -> physical
# ---------------------------------------------------------------------------
#
# FSDP/ZeRO-3: weight matrices shard their d_model-like dim over the ``fsdp``
# axes (data, and pod when multi-pod) and their TP dim over ``model``.  A
# divisibility check demotes any dim that does not divide the mesh axis size
# to replicated (e.g. whisper's 20 heads, granite's single KV head), the
# generic mechanism that makes all ten archs shardable with one rule table.
#
# Every helper reads only the mesh's axis sizes: give it a DeviceMesh or a
# plain ``{axis: size}`` mapping.  Trees are the port's nested dicts, their
# leaves named by their dotted paths (``layers.stacked.attn.wq``), which are
# the JAX trees' paths; a spec is a tuple (see :mod:`.api`).

def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a DeviceMesh (in its axis order) or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def gram_specs(mesh, Bx: int, By: int, *, row_axis: str = "data",
               col_axis: str = "model") -> Tuple[Spec, Spec, Spec]:
    """Specs ``(rows_spec, cols_spec, gram_spec)`` for a (Bx, By) Gram
    tiling: X rows over ``row_axis``, Y rows over ``col_axis``, the Gram
    over both.  Reuses :func:`physical_spec`'s divisibility demotion: a
    batch that does not divide its mesh axis is replicated."""
    rules = {"batch": row_axis, "model": col_axis, None: None}
    rows = physical_spec(("batch",), (Bx,), mesh, rules)
    cols = physical_spec(("model",), (By,), mesh, rules)
    gram = physical_spec(("batch", "model"), (Bx, By), mesh, rules)
    return rows, cols, gram


# logical specs by trailing path name; rank refers to the UNSTACKED param
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "table":      ("model", "fsdp"),          # embeddings: vocab x d_model
    "wq":         ("fsdp", "model", None),
    "wk":         ("fsdp", "model", None),
    "wv":         ("fsdp", "model", None),
    "wo":         ("model", None, "fsdp"),
    "bq":         ("model", None),
    "bk":         ("model", None),
    "bv":         ("model", None),
    "w_gate":     ("fsdp", "model"),
    "w_up":       ("fsdp", "model"),
    "w_in":       ("fsdp", "model"),
    "w_out":      ("model", "fsdp"),
    "router":     ("fsdp", None),
    "shared_gate": ("fsdp", None),
    "patch_proj": (None, "fsdp"),
    "sig_proj":   (None, None),
    # mamba2 (packed projections: replicate TP, shard over fsdp only)
    "in_proj":    ("fsdp", None),
    "out_proj":   (None, "fsdp"),
    "conv_w":     (None, "model"),
    "conv_b":     ("model",),
    "A_log":      (None,),
    "D":          (None,),
    "dt_bias":    (None,),
    # rg-lru
    "w_x":        ("fsdp", "model"),
    "w_y":        ("fsdp", "model"),
    "w_a":        (None, "model"),
    "w_i":        (None, "model"),
    "b_a":        ("model",),
    "b_i":        ("model",),
    "lam":        ("model",),
    # norms
    "scale":      (None,),
    "bias":       (None,),
}

# MoE expert tensors (parent name "moe"): (E, D, F) / (E, F, D).  The F dim
# lists "model" as a fallback: when the expert count does not divide the
# model axis (e.g. Qwen's 60 experts), the per-expert hidden is
# tensor-parallel instead; the used-axis bookkeeping in physical_spec picks
# exactly one of the two.
_MOE_RULES = {
    "w_gate": ("expert", "fsdp", "model"),
    "w_up":   ("expert", "fsdp", "model"),
    "w_out":  ("expert", "model", "fsdp"),
}


def rules_for(cfg, multi_pod: bool) -> Dict[Optional[str], Axis]:
    """Logical -> physical mapping, with per-family overrides."""
    base = dict(MULTIPOD_RULES if multi_pod else DEFAULT_RULES)
    if cfg is not None and getattr(cfg, "family", None) == "ssm":
        # mamba2: packed projections are not TP-friendly; use the model axis
        # as extra batch/FSDP parallelism, but keep it available for the
        # embedding/logits vocab dim and the residual-stream sequence dim
        base["batch"] = (("pod", "data") if multi_pod else ("data", "model"))
        base["fsdp"] = (("pod", "data", "model") if multi_pod
                        else ("data", "model"))
        base["expert"] = None
    return base


def _axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, str):
        return shape[axis]
    return math.prod(shape[a] for a in axis)


def logical_spec_for(path: Tuple[str, ...], leaf) -> Tuple[Optional[str], ...]:
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    grandparent = path[-3] if len(path) > 2 else ""
    if name in _MOE_RULES and ("moe" in (parent, grandparent)):
        base = _MOE_RULES[name]
    elif name in _RULES:
        base = _RULES[name]
    else:
        base = (None,) * leaf.ndim
    if leaf.ndim == len(base) + 1:          # scan-stacked: leading layer dim
        base = (None,) + base
    elif leaf.ndim != len(base):            # unexpected rank: replicate
        base = (None,) * leaf.ndim
    return base


def physical_spec(logical: Tuple[Optional[str], ...], shape, mesh,
                  rules: Dict[Optional[str], Axis]) -> Spec:
    sizes = mesh_shape(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axis = rules.get(name, None)
        axes = (axis,) if isinstance(axis, str) else tuple(axis or ())
        axes = tuple(a for a in axes if a not in used)
        # progressively drop trailing axes until the dim divides the product
        while axes and dim % math.prod(sizes[a] for a in axes) != 0:
            axes = axes[:-1]
        if axes:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return tuple(out)


def _tree_map_path(fn, tree: Dict, path: Tuple[str, ...] = ()) -> Dict:
    return {k: _tree_map_path(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def param_shardings(params, cfg, mesh, multi_pod: bool) -> Dict:
    """Tree of specs for a params tree (or an optimizer state tree over one:
    the rules read the last three names of a path)."""
    rules = rules_for(cfg, multi_pod)

    def one(path, leaf):
        return physical_spec(logical_spec_for(path, leaf), leaf.shape, mesh, rules)

    return _tree_map_path(one, params)


def batch_shardings(batch, cfg, mesh, multi_pod: bool) -> Dict:
    """Inputs: batch dim over the batch axes, everything else replicated."""
    rules = rules_for(cfg, multi_pod)

    def one(path, leaf):
        if leaf.ndim == 0:
            return ()
        return physical_spec(("batch",) + (None,) * (leaf.ndim - 1), leaf.shape, mesh, rules)

    return _tree_map_path(one, batch)


def replicated(mesh) -> Spec:
    """The replicated spec (JAX's ``P()``): every dim whole on every device."""
    return ()


# logical specs for decode-cache leaves, keyed by leaf name (UNSTACKED rank)
_CACHE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "k":    ("batch", None, "model", None),     # (B, S, KV, hd)
    "v":    ("batch", None, "model", None),
    "ck":   ("batch", None, "model", None),     # whisper cross K/V
    "cv":   ("batch", None, "model", None),
    "pos":  (None,),                            # ring positions (W,)
    "conv": ("batch", None, "model"),           # conv tail (B, K, C)
    "state": ("batch", "model", None, None),    # ssm state (B, H, N, P)
    "h":    ("batch", "model"),                 # rg-lru state (B, W)
}


def cache_shardings(caches, cfg, mesh, multi_pod: bool) -> Dict:
    """Specs for decode caches (the batch dim is not dim 0 when layers are
    scan-stacked: handled by the rank adjustment)."""
    rules = rules_for(cfg, multi_pod)

    def one(path, leaf):
        name = path[-1]
        base = _CACHE_RULES.get(name, None)
        if base is None:
            logical = (None,) * leaf.ndim
        else:
            logical = base
            if name in ("k", "v", "ck", "cv"):
                # TP the cache on KV heads when they divide the model axis;
                # else shard the SEQUENCE dim (flash-decoding style); else
                # head_dim.  A replicated cache wastes the whole model axis
                # of HBM.
                S, kv, hd = leaf.shape[-3], leaf.shape[-2], leaf.shape[-1]
                tp = _axis_size(mesh, rules.get("model"))
                if tp > 1 and kv % tp != 0:
                    if S % tp == 0:
                        logical = ("batch", "model", None, None)
                    elif hd % tp == 0:
                        logical = ("batch", None, None, "model")
            if leaf.ndim == len(logical) + 1:   # stacked over layers
                logical = (None,) + tuple(logical)
            elif leaf.ndim != len(logical):
                logical = (None,) * leaf.ndim
        return physical_spec(logical, leaf.shape, mesh, rules)

    return _tree_map_path(one, caches)


def placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a DeviceMesh, or a
    mapping whose keys are the mesh's axes in order): ``Shard(d)`` on each
    mesh axis that tensor dim ``d`` names, ``Replicate()`` on the others.

    A dim split over several axes lists them major first, and DTensor
    splits a dim over the mesh's axes in the mesh's order: every rule here
    names them so (``("pod", "data")``, ``("data", "model")``, ``("pod",
    "data", "model")``).  A spec that names them in another order, or names
    one axis twice, is refused (it would need a strided shard).  An axis of
    one device splits nothing: its placement is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if out[i] is not None and not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {names[i]!r} twice")
            out[i] = Shard(d) if sizes[names[i]] > 1 else None
    return tuple(Replicate() if p is None else p for p in out)


def spec_of(placements_, mesh, ndim: int) -> Spec:
    """The spec of DTensor ``placements_`` on ``mesh`` over ``ndim`` dims:
    the inverse of :func:`placements`."""
    names = list(mesh_shape(mesh))
    dims: Dict[int, list] = {}
    for name, p in zip(names, placements_):
        if p.is_shard():
            dims.setdefault(p.dim, []).append(name)
    return tuple(None if d not in dims else (dims[d][0] if len(dims[d]) == 1 else tuple(dims[d]))
                 for d in range(ndim))


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` laid out by
    ``spec`` (every rule keeps the shards even)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            out[d] //= sizes[a]
    return tuple(out)


def distribute_zeros(tree: Dict, specs: Dict, mesh, device=None) -> Dict:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` laid out by its spec,
    its local shard fresh zeros of the leaf's dtype on ``device`` (default:
    the leaf's): what a device allocates for its share, with no
    collective."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        if isinstance(t, dict):
            return {k: one(v, spec[k]) for k, v in t.items()}
        local = torch.zeros(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device=t.device if device is None else device)
        return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                                  shape=t.shape, stride=t.stride())

    return one(tree, specs)


def distribute(tree: Dict, specs: Dict, mesh) -> Dict:
    """Each leaf of ``tree`` (the whole tensor, alike on every device) as a
    DTensor on ``mesh`` laid out by its spec: each device keeps its own
    shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        if isinstance(t, dict):
            return {k: one(v, spec[k]) for k, v in t.items()}
        return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)

    return one(tree, specs)
