"""The Gram engine: one entry point for the signature-kernel Gram variants.

Counterpart of the single-device engine in ``repro/core/gram.py``:

* **dense** — all ``Bx·By`` problems at once;
* **row-blocked** (``row_block=``) — ``row_block`` Gram rows in flight at a
  time.  The JAX engine zero-pads ``Bx`` to the block for ``lax.map``; a
  Python loop needs no padding, so the last block is just shorter;
* **fused** (``backend="gpu_fused"``) — Δ is built inside the CUDA kernel
  from the increments and never exists in device memory;
* **symmetric** (``Y`` omitted) — only the ``Bx·(Bx+1)/2`` upper-triangle
  pairs are solved, then mirrored.

:func:`sigkernel_gram_reduce` is the streaming layer: ``Σ K`` without the
Gram, at most one block of solves alive in the forward and the backward.
Its guard (``check_streaming=True``, on in ``mmd2`` / ``scoring_rule``
whenever they stream; :func:`assert_streaming_reduction`) proves that on
fake tensors, once per shape and config, before the reduction runs.
Every variant is differentiable with the exact one-pass backward.

``features=`` (a :class:`repro_torch.core.features.FeatureConfig`)
switches every entry point to an approximate feature map (``"rff"`` /
``"nystroem"``): the Gram becomes ``phi(X) @ phi(Y).T`` and the reduction
``⟨Σ phi(X), Σ phi(Y)⟩``, O(B·rank) memory, differentiable by autograd.
Without it, or ``error_budget=``, the approximate backends are refused,
even when named.  ``error_budget=`` (a relative-error budget) lets
``backend="auto"`` take a cheaper engine that the autotune cache has
*measured* within the budget on this machine: an RFF / Nyström point of
:func:`repro_torch.bench.autotune.tune_frontier`, else (from the default
``GridConfig``) a coarser grid, the order-2 stencil or bf16 interiors of
:func:`~repro_torch.bench.autotune.tune_scheme_frontier`.  A cold cache, a
foreign machine or no qualifying point gives the exact engine, bit for bit
the call without the budget.

:func:`sigkernel_gram_sharded` tiles the Gram over the ranks of a
``torch.distributed`` DeviceMesh (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from . import dispatch
from . import features as ft
from . import transforms as tf
from .config import (_maybe_scale, delta_from_gram, resolve_kernel_configs,
                     resolve_launch)
from .sigkernel import _sigkernel_from_delta
from repro_torch import spans
from repro_torch.kernels.sigkernel_pde import ops as pde_ops
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.api import shard
from repro_torch.parallel.sharding import block_cyclic_perm


@spans.spanned(spans.PREPARE)
def _prepare(paths: torch.Tensor, cfg, kernel, lengths=None) -> torch.Tensor:
    """Per-path stream the pair solvers consume: transformed increments for
    the linear lift, transformed points otherwise; end-aligned when ragged."""
    if kernel.lifts_increments:
        return tf.pipeline_increments(paths, cfg, lengths, align="end")
    return tf.transform_path(paths, cfg, lengths, align="end")


def _pair_delta(sa: torch.Tensor, sb: torch.Tensor, kernel) -> torch.Tensor:
    """Δ for batches of prepared streams (leading dims broadcast)."""
    with spans.span(spans.DELTA):
        if kernel.lifts_increments:
            return kernel.delta_from_increments(sa, sb)
        return delta_from_gram(kernel.gram(sa, sb))


def _upload(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    """The numpy array ``a`` as a tensor on ``device``.  On the card this is
    a blocking copy from pageable memory, which waits for the stream: it is
    counted (:class:`dispatch.count_host_syncs`, on every device) and
    marked (``repro_torch.sync``)."""
    dispatch.record_host_syncs(1)
    with spans.span(spans.SYNC):
        return torch.as_tensor(a, dtype=dtype, device=device)


def _solve_pairs(sa: torch.Tensor, sb: torch.Tensor, kernel, backend: str, g,
                 launch=None) -> torch.Tensor:
    """Solve one batch of prepared pairs (P, ·, d) × (P, ·, d) -> (P,)."""
    if backend == "gpu_fused":
        # scale·⟨dx, dy⟩ = ⟨scale·dx, dy⟩: fold a linear scale into one side
        return pde_ops.solve_fused(_maybe_scale(sa, kernel.scale), sb, g.lam1,
                                   g.lam2, launch, g.scheme, g.interior_dtype)
    return _sigkernel_from_delta(_pair_delta(sa, sb, kernel), g, backend, launch)


def _gram_block(sxb: torch.Tensor, sY: torch.Tensor, kernel, backend: str, g,
                launch=None) -> torch.Tensor:
    """Gram block from prepared streams (r, ·, d) × (By, ·, d) -> (r, By)."""
    if backend == "gpu_fused":
        return pde_ops.gram_fused(_maybe_scale(sxb, kernel.scale), sY, g.lam1,
                                  g.lam2, launch, g.scheme, g.interior_dtype)
    delta = _pair_delta(sxb[:, None], sY[None, :], kernel)
    return _sigkernel_from_delta(delta, g, backend, launch)


def _gram_rows(sX: torch.Tensor, sY: torch.Tensor, kernel, backend: str, g,
               row_block: Optional[int], launch=None) -> torch.Tensor:
    """(Bx, ·, d) × (By, ·, d) -> (Bx, By), optionally ``row_block`` rows
    at a time."""
    if row_block is None:
        return _gram_block(sX, sY, kernel, backend, g, launch)
    return torch.cat([_gram_block(sxb, sY, kernel, backend, g, launch)
                      for sxb in sX.split(row_block)])


def _solve_pairs_chunked(sX: torch.Tensor, a_idx, b_idx, kernel, backend: str,
                         g, chunk: Optional[int], launch=None) -> torch.Tensor:
    """k values for a pair list into one stream batch, at most ``chunk``
    pairs of gathered streams alive at once."""
    a_idx = _upload(a_idx, sX.device)
    b_idx = _upload(b_idx, sX.device)
    n = a_idx.shape[0]
    if chunk is None or chunk >= n:
        return _solve_pairs(sX[a_idx], sX[b_idx], kernel, backend, g, launch)
    return torch.cat([_solve_pairs(sX[a], sX[b], kernel, backend, g, launch)
                      for a, b in zip(a_idx.split(chunk), b_idx.split(chunk))])


#: bytes of gathered pair streams above which an unset ``row_block`` is
#: chosen for the symmetric path, so it never costs more memory than the
#: dense Gram it replaces
_SYM_GATHER_BUDGET = 64 * 1024 * 1024


def _auto_row_block(other: int, L: int, d: int) -> int:
    """Row block bounding one block's gathered-stream bytes by the budget."""
    return max(1, _SYM_GATHER_BUDGET // (8 * max(1, other) * L * d))


def _symmetric_gram(sX: torch.Tensor, kernel, backend: str,
                    row_block: Optional[int], g, launch=None) -> torch.Tensor:
    """Upper-triangle pair solve + mirror: Bx·(Bx+1)/2 PDE solves."""
    Bx = sX.shape[0]
    a_np, b_np = np.triu_indices(Bx)
    n_pairs = a_np.size
    if row_block is None and 8 * n_pairs * sX.shape[1] * sX.shape[2] \
            > _SYM_GATHER_BUDGET:
        row_block = _auto_row_block(Bx, sX.shape[1], sX.shape[2])
    chunk = None if row_block is None else max(1, int(row_block)) * Bx
    dispatch.record_pair_solves(n_pairs)
    k = _solve_pairs_chunked(sX, a_np, b_np, kernel, backend, g, chunk, launch)
    return _mirror(k, a_np, b_np, Bx)


def _mirror(k: torch.Tensor, a_np, b_np, Bx: int) -> torch.Tensor:
    """The (Bx, Bx) Gram from its upper-triangle values ``k`` at (a, b)."""
    a_idx = _upload(a_np, k.device)
    b_idx = _upload(b_np, k.device)
    K = k.new_zeros(Bx, Bx).index_put((a_idx, b_idx), k)
    return K.index_put((b_idx, a_idx), k)     # the mirror; diagonal once


@spans.spanned(spans.FRONT_END)
def _resolve_engine(X, Y, symmetric, lengths, lengths_y, transforms, grid,
                    static_kernel, backend, launch, features=None, error_budget=None):
    """Shared front end: validation, configs, ragged padding, dispatch.

    Returns the padded (and, for a coarsened scheme point, subsampled)
    batches, configs, the resolved backend, and the active
    :class:`FeatureConfig` (None for the exact engine).  An approximation
    activates one of three ways: ``features=``; a named approximate backend
    with ``features=`` or ``error_budget=`` (its measured frontier rank, or
    the default rank on a cold cache); or ``backend="auto"`` with
    ``error_budget=`` and a measured frontier point meeting it
    (:func:`dispatch.resolve_approx`).  Without one of these a named
    approximate backend is refused by :func:`dispatch.resolve`."""
    if X.dim() != 3 or (Y is not None and Y.dim() != 3):
        raise ValueError(
            f"sigkernel_gram expects (B, L, d) paths, got X {tuple(X.shape)}"
            + ("" if Y is None else f", Y {tuple(Y.shape)}"))
    if symmetric is None:
        symmetric = Y is None
    if symmetric and not (Y is None or Y is X):
        raise ValueError("symmetric=True requires Y to be None or X itself")
    if not symmetric and Y is None:
        raise ValueError("symmetric=False requires Y (pass Y=X for the "
                         "full symmetric Gram without the fast path)")
    if lengths_y is not None and Y is None:
        raise ValueError("lengths_y= requires Y; for the symmetric Gram "
                         "pass lengths= (it applies to both sides)")
    cfg, g, kernel = resolve_kernel_configs(transforms, grid, static_kernel)
    launch = resolve_launch(launch)
    if lengths is not None:
        X, lengths = tf.pad_ragged(X, lengths)
    if lengths_y is not None:
        Y, lengths_y = tf.pad_ragged(Y, lengths_y)
    ragged = lengths is not None or lengths_y is not None
    backend = dispatch.canonicalize(backend, op="gram")
    if backend == "gpu_fused" and not kernel.lifts_increments:
        raise ValueError(
            "backend='gpu_fused' builds Δ from increments inside the kernel and "
            f"only supports the linear lift, got static_kernel="
            f"{type(kernel).__name__}; pass backend='auto'")
    By = X.shape[0] if Y is None else Y.shape[0]
    Lx, Ly, key = _key_dims(X, Y, cfg, g, By)
    feats = ft.resolve_features(features)
    if feats is not None and backend not in ("auto", feats.method):
        raise ValueError(
            f"features=FeatureConfig(method={feats.method!r}) conflicts "
            f"with backend={backend!r}; pass backend='auto' or "
            f"backend={feats.method!r}")
    explicit_approx = backend != "auto" and dispatch.get(backend).approximate
    budget = dict(device=X.device, error_budget=error_budget, ragged=ragged)
    # the feature maps implement the order-1 stencil only: a named one the
    # caller opted into is refused for another scheme with the capability
    # error, and a non-default scheme keeps "auto" off the frontier
    if explicit_approx and (features is not None or error_budget is not None):
        dispatch.check_scheme(backend, g.scheme, op="gram")
    if feats is None and error_budget is not None and g.scheme == "order1" \
            and (explicit_approx or backend == "auto"):
        found = dispatch.resolve_approx("gram", key, X.dtype, **budget)
        if explicit_approx:
            # the measured rank when the frontier names this method, else
            # the library default
            rank = found[1] if found is not None and found[0] == backend \
                else ft.FeatureConfig.rank
            feats = ft.FeatureConfig(method=backend, rank=rank)
        elif found is not None:
            feats = ft.FeatureConfig(method=found[0], rank=found[1])
    if feats is None and backend == "auto" and error_budget is not None \
            and g.scheme == "order1" and g.interior_dtype == "float32":
        # a measured discretisation of the exact engine within the budget;
        # an explicit scheme or interior dtype is never overridden
        g, X, Y, Lx, Ly, key = _apply_scheme_point(
            dispatch.resolve_scheme("gram", key, X.dtype, **budget),
            g, X, Y, cfg, ragged, By)
    if feats is not None:
        backend = dispatch.resolve(feats.method, op="gram", device=X.device,
                                   allow_approximate=True, scheme=g.scheme)
        return X, Y, lengths, lengths_y, cfg, g, kernel, backend, symmetric, launch, feats
    backend = dispatch.resolve(backend, op="gram", device=X.device,
                               grid_cells=(Lx << g.lam1) * (Ly << g.lam2), shape=key,
                               dtype=X.dtype, allow_fused=kernel.lifts_increments,
                               ragged=ragged, scheme=g.scheme)
    return X, Y, lengths, lengths_y, cfg, g, kernel, backend, symmetric, launch, None


def _apply_scheme_point(found, g, X, Y, cfg, ragged, By):
    """Apply a scheme-frontier point ``(scheme, coarsen, interior_dtype)``.

    ``coarsen`` halves the PDE grid ``coarsen`` times: by dropping dyadic
    refinement levels where both are deep enough, else by stride-subsampling
    the paths (dense batches only: ragged lengths would shift, so the point
    is not applied there).  Returns ``(g, X, Y, Lx, Ly, key shape)``."""
    if found is None:
        return g, X, Y, *_key_dims(X, Y, cfg, g, By)
    scheme_p, coarsen, idt = found
    if coarsen:
        if g.lam1 >= coarsen and g.lam2 >= coarsen:
            g = dataclasses.replace(g, lam1=g.lam1 - coarsen, lam2=g.lam2 - coarsen)
        elif not ragged and X.shape[1] > (1 << coarsen):
            step = 1 << coarsen
            X = X[:, ::step]
            Y = Y if Y is None else Y[:, ::step]
        else:
            return g, X, Y, *_key_dims(X, Y, cfg, g, By)
    g = dataclasses.replace(g, scheme=scheme_p, interior_dtype=idt)
    return g, X, Y, *_key_dims(X, Y, cfg, g, By)


def _key_dims(X, Y, cfg, g, By):
    """(Lx, Ly, key shape) for the current paths and config: the Gram's
    autotune key ``(Bx, By, nx, ny, d')`` of
    :func:`repro_torch.bench.autotune.key_shape`."""
    Lx = cfg.transformed_steps(X.shape[1])
    Ly = Lx if Y is None else cfg.transformed_steps(Y.shape[1])
    return Lx, Ly, (X.shape[0], By, Lx << g.lam1, Ly << g.lam2,
                    cfg.transformed_dim(X.shape[-1]))


# ---------------------------------------------------------------------------
# approximate feature maps — phi(X) whose inner products approximate K
# ---------------------------------------------------------------------------

def _nystroem_maps(sX, sY, feats, kernel, backend: str, g, launch, pool_idx=None):
    """Nyström features from prepared streams: phi = K(·, Z)·L_w^{-T}.

    The landmarks Z are pivoted-Cholesky picks from the pool ``pool_idx``
    (default :func:`features.nystroem_pool` of ``feats`` on the streams'
    device): pool² exact solves for the pool Gram, then ``rank`` a path.
    The pivots are chosen without gradient; everything gathered at them
    stays differentiable."""
    Bx = sX.shape[0]
    if pool_idx is None:
        pool_idx = ft.nystroem_pool(feats, Bx, device=sX.device)
    pool = pool_idx.shape[0]
    rank = min(feats.rank, pool)
    sP = sX[pool_idx]
    dispatch.record_pair_solves(
        pool * pool + Bx * rank + (0 if sY is None else sY.shape[0] * rank))
    G_pool = _gram_block(sP, sP, kernel, backend, g, launch)
    piv, _ = ft.pivoted_cholesky(G_pool, rank)
    sZ = sP[piv]
    Lw = ft.nystroem_factor(G_pool[piv][:, piv], feats.jitter)
    phiX = ft.nystroem_phi(_gram_rows(sX, sZ, kernel, backend, g, None, launch), Lw)
    if sY is None:
        return phiX, None
    return phiX, ft.nystroem_phi(_gram_rows(sY, sZ, kernel, backend, g, None, launch), Lw)


def _feature_maps(X, Y, feats, cfg, g, kernel, lengths, lengths_y, launch):
    """phi(X), phi(Y) under ONE shared draw (phi(Y) is None when Y is):
    sharing the draw is what makes ⟨phi(X), phi(Y)⟩ a kernel estimate."""
    if feats.method == "rff":
        draws = ft.rff_draws(feats, kernel, cfg.transformed_dim(X.shape[-1]),
                             dtype=X.dtype, device=X.device)
        phiX = ft.rff_features(X, feats, cfg, kernel, lengths, draws)
        phiY = None if Y is None else ft.rff_features(Y, feats, cfg, kernel,
                                                      lengths_y, draws)
        return phiX, phiY
    # the pool and cross Grams run the exact engine's "auto" backend
    exact = dispatch.resolve("auto", op="gram", device=X.device,
                             allow_fused=kernel.lifts_increments, scheme=g.scheme)
    sX = _prepare(X, cfg, kernel, lengths)
    sY = None if Y is None else _prepare(Y, cfg, kernel, lengths_y)
    return _nystroem_maps(sX, sY, feats, kernel, exact, g, launch)


@spans.spanned(spans.ENTRY_GRAM)
def sigkernel_gram(X: torch.Tensor, Y: Optional[torch.Tensor] = None, *,
                   backend: str = "auto", row_block: Optional[int] = None,
                   symmetric: Optional[bool] = None, lengths=None,
                   lengths_y=None, transforms=None, grid=None,
                   static_kernel=None, launch=None, features=None,
                   error_budget=None) -> torch.Tensor:
    """Signature-kernel Gram matrix ``K[a, b] = k(X_a, Y_b)``.

    Args:
      X: (Bx, L, d) paths.
      Y: (By, L', d) paths, or ``None`` for the symmetric Gram of ``X``
        (upper triangle only, ≈2× fewer PDE solves).
      backend: ``"auto"`` (CUDA: ``"gpu_fused"`` for the linear lift, else
        ``"gpu"``; CPU: the plain solvers), or a registered name.
      row_block: at most this many Gram rows (or ``row_block·Bx`` symmetric
        pairs) in flight; default ``launch.gram_row_block``.
      symmetric: force/forbid the symmetric path (default: ``Y is None``).
      lengths / lengths_y: per-path true point counts (ragged batches).
      transforms / grid / static_kernel / launch: the configs.
      features: a :class:`FeatureConfig` switching to the approximate
        feature map it names: ``phi(X) @ phi(Y).T`` with no Bx·By solve grid.
        Without it, or ``error_budget=``, ``backend="rff"``/``"nystroem"``
        is refused.
      error_budget: a relative-error budget letting ``backend="auto"`` take
        a cheaper engine the autotune cache measured within it on this
        machine (a feature map, or a coarser grid / order-2 stencil / bf16
        interiors of the exact engine); otherwise the exact engine runs,
        bit for bit the call without it.

    Returns the (Bx, By) Gram (f32 on the card), differentiable in X and Y.
    """
    (X, Y, lengths, lengths_y, cfg, g, kernel, backend, symmetric,
     launch, feats) = _resolve_engine(X, Y, symmetric, lengths, lengths_y, transforms,
                                      grid, static_kernel, backend, launch, features,
                                      error_budget)
    if feats is not None:
        phiX, phiY = _feature_maps(X, Y, feats, cfg, g, kernel, lengths, lengths_y,
                                   launch)
        return shard(phiX @ (phiX if phiY is None else phiY).T, "batch", "model")
    if row_block is None:
        row_block = launch.gram_row_block
    sX = shard(_prepare(X, cfg, kernel, lengths), "batch", None, None)
    if symmetric:
        return shard(_symmetric_gram(sX, kernel, backend, row_block, g, launch),
                     "batch", "model")
    sY = shard(_prepare(Y, cfg, kernel, lengths_y), "model", None, None)
    dispatch.record_pair_solves(sX.shape[0] * sY.shape[0])
    return shard(_gram_rows(sX, sY, kernel, backend, g, row_block, launch), "batch", "model")


# ---------------------------------------------------------------------------
# sharded Gram — the (Bx, By) tile grid over the ranks of a DeviceMesh
# ---------------------------------------------------------------------------

def _mesh_groups(mesh, row_axis: str, col_axis: str, device: torch.device):
    """The row and column process groups of ``mesh``, checked."""
    names = tuple(mesh.mesh_dim_names or ())
    for ax in (row_axis, col_axis):
        if ax not in names:
            raise ValueError(f"mesh has no {ax!r} axis (axes: {names}); pass "
                             "row_axis=/col_axis= matching your mesh")
    if row_axis == col_axis:
        raise ValueError(f"row_axis and col_axis are both {row_axis!r}")
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} but the paths lie on "
                         f"{device.type!r}: NCCL meshes take card tensors, gloo "
                         "meshes CPU tensors")
    groups = mesh.get_group(row_axis), mesh.get_group(col_axis)
    if device.type == "cuda" and any("nccl" not in dist.get_backend(gr) for gr in groups):
        raise ValueError("card tensors need an NCCL mesh: gloo moves them through the host")
    return groups


def _deal(s: torch.Tensor, n_shards: int, index: int, tile: int):
    """Shard ``index`` of the zero-padded, block-cyclically dealt rows of
    ``s``; returns (its rows, the inverse permutation, the padded count).
    Zero rows give k = 1 tiles, which the caller slices off."""
    B = s.shape[0]
    t = max(1, min(int(tile), -(-B // n_shards)))
    n_blocks = -(-B // t)
    n_blocks += (-n_blocks) % n_shards
    padded = n_blocks * t
    if padded > B:
        s = torch.cat([s, s.new_zeros((padded - B,) + tuple(s.shape[1:]))])
    perm, inv = block_cyclic_perm(padded, n_shards, t)
    share = padded // n_shards
    idx = _upload(perm[index * share:(index + 1) * share], s.device)
    return s[idx], _upload(inv, s.device), padded


def _shared_params(kernel, groups):
    """The lift with each of its differentiable tensors (``RBF.sigma``,
    ``Linear.scale``) through :func:`collectives.sum_grads`: each rank's
    tiles give only their share of its gradient."""
    wrapped = {}
    for f in dataclasses.fields(kernel):
        v = getattr(kernel, f.name)
        if isinstance(v, torch.Tensor) and v.requires_grad:
            wrapped[f.name] = coll.sum_grads(v, groups)
    return dataclasses.replace(kernel, **wrapped) if wrapped else kernel


@spans.spanned(spans.ENTRY_GRAM_SHARDED)
def sigkernel_gram_sharded(X: torch.Tensor, Y: Optional[torch.Tensor] = None, *,
                           mesh=None, row_axis: str = "data", col_axis: str = "model",
                           tile: int = 8, backend: str = "auto",
                           row_block: Optional[int] = None,
                           symmetric: Optional[bool] = None, lengths=None,
                           lengths_y=None, transforms=None, grid=None,
                           static_kernel=None, launch=None,
                           features=None, error_budget=None) -> torch.Tensor:
    """:func:`sigkernel_gram` tiled over the ranks of a DeviceMesh.

    **Contract.**  Every rank of ``mesh`` calls this with the same ``X``,
    ``Y``, lengths and configs, and every rank gets the whole (Bx, By)
    Gram back (as the JAX function returns one global array); it is
    differentiable on every rank, and ``torch.autograd.grad`` of the same
    loss of it gives every rank the whole gradient, equal to the dense
    Gram's.  The collectives run on the mesh's groups: NCCL for card
    tensors (one process a card), gloo for CPU tensors.

    The (Bx, By) tile grid is 2-D **block-cyclic**: row tiles of ``tile``
    paths dealt round-robin over ``mesh[row_axis]``, column tiles over
    ``mesh[col_axis]`` (zero-padded to whole rounds; padding rows give
    k = 1 and are sliced off).  Each rank solves its (rows × columns) tile
    from the replicated prepared streams with no collective, then the tiles
    are gathered over the column and the row groups and the deal undone.
    On the card the linear lift's tiles go to the fused Gram kernel, other
    lifts' to the precomputed-Δ forward.

    The symmetric fast path (``Y`` omitted) stays global: the
    ``Bx·(Bx+1)/2`` upper-triangle pairs, padded to a multiple of the rank
    count ``D``, are dealt round-robin over **all** ranks (rank ``r``
    solves pairs ``r, r + D, …``), solved locally, gathered and mirrored
    once.  The cyclic deal keeps the triangle balanced.

    The gradient: the gather's backward hands each rank its own slice of
    the cotangent, and the replicated prepared streams (and the lift's
    differentiable tensors) sum their gradients over the mesh in the
    backward (:mod:`repro_torch.parallel.collectives`).  Each tile belongs
    to one rank, so the sum is the whole gradient.

    :func:`count_pair_solves` records the **global** budget on every rank,
    as the JAX function's counter does: ``n_pairs + pad`` symmetric,
    ``padded_Bx · padded_By`` otherwise; a rank's own share is that budget
    over the rank count.

    Args (beyond :func:`sigkernel_gram`'s; ``error_budget=`` resolves on
    every rank from the same cache, so every rank takes the same engine):
      mesh: a ``torch.distributed.device_mesh.DeviceMesh`` with ``row_axis``
        and ``col_axis`` dimensions, on the paths' device type.  Default:
        :func:`repro_torch.launch.make_gram_mesh` over the default group.
      tile: block-cyclic tile granularity (rows and columns).
      row_block: at most ``row_block`` local Gram rows (or ``row_block·Bx``
        symmetric pairs) in flight on each rank.
      features: with a :class:`FeatureConfig` there is no solve grid to
        tile: every rank computes the feature maps and the (Bx, rank) @
        (rank, By) product ``phi(X) @ phi(Y).T`` whole, with no collective
        (the JAX function's result is replicated in effect), and no mesh is
        needed.

    Ragged ``lengths=`` work unchanged: the end-aligned prepared streams
    carry the padding before the tiles are dealt.  Values equal the dense
    Gram's pair for pair (only the concatenation order differs).
    """
    (X, Y, lengths, lengths_y, cfg, g, kernel, backend, symmetric,
     launch, feats) = _resolve_engine(X, Y, symmetric, lengths, lengths_y, transforms,
                                      grid, static_kernel, backend, launch, features,
                                      error_budget)
    if feats is not None:
        phiX, phiY = _feature_maps(X, Y, feats, cfg, g, kernel, lengths, lengths_y, launch)
        phiX = shard(phiX, "batch", None)
        K = phiX @ (phiX if phiY is None else shard(phiY, "model", None)).T
        return shard(K, "batch", "model")
    if mesh is None:
        from repro_torch.launch import make_gram_mesh
        mesh = make_gram_mesh()
    rows, cols = _mesh_groups(mesh, row_axis, col_axis, X.device)
    groups = (rows, cols)
    nd, nm = dist.get_world_size(rows), dist.get_world_size(cols)
    i, j = dist.get_rank(rows), dist.get_rank(cols)
    D, r = nd * nm, i * nm + j           # rank r of the flat deal

    if row_block is None:
        row_block = launch.gram_row_block
    kernel = _shared_params(kernel, groups)
    sX = coll.sum_grads(_prepare(X, cfg, kernel, lengths), groups)
    Bx = sX.shape[0]
    if symmetric:
        a_np, b_np = np.triu_indices(Bx)
        n_pairs = a_np.size
        pad = (-n_pairs) % D
        a_pad = np.concatenate([a_np, np.zeros(pad, a_np.dtype)])
        b_pad = np.concatenate([b_np, np.zeros(pad, b_np.dtype)])
        n_loc = (n_pairs + pad) // D
        dispatch.record_pair_solves(n_pairs + pad)
        chunk = None if row_block is None else max(1, int(row_block)) * Bx
        k_loc = _solve_pairs_chunked(sX, a_pad[r::D], b_pad[r::D], kernel, backend, g,
                                     chunk, launch)
        # undo the deal: global pair t·D + r sits at rank r, slot t
        k = coll.gather(coll.gather(k_loc, cols), rows)
        k = k.reshape(D, n_loc).T.reshape(-1)[:n_pairs]
        return shard(_mirror(k, a_np, b_np, Bx), "batch", "model")

    sY = coll.sum_grads(_prepare(Y, cfg, kernel, lengths_y), groups)
    By = sY.shape[0]
    sx, inv_r, px = _deal(sX, nd, i, tile)
    sy, inv_c, py = _deal(sY, nm, j, tile)
    dispatch.record_pair_solves(px * py)
    Kt = _gram_rows(sx, sy, kernel, backend, g, row_block, launch)
    Kp = coll.gather(coll.gather(Kt, cols, dim=1), rows)
    return shard(Kp[inv_r][:, inv_c][:Bx, :By], "batch", "model")


# ---------------------------------------------------------------------------
# streaming reductions — ΣK without materialising K (mmd2 / scoring_rule)
# ---------------------------------------------------------------------------

class StreamingViolation(RuntimeError):
    """A reduction that was asked to stream materialises the full Gram (or
    the full pairwise Δ stack) as an intermediate."""


def assert_streaming_reduction(fn, *args, gram_shape, what: str = "reduction",
                               grad: bool = False) -> None:
    """Trace ``fn(*args)`` on fake tensors and raise
    :class:`StreamingViolation` if any intermediate has leading dims
    ``gram_shape = (Bx, By)``.

    ``args`` may be tensors (their shape, dtype and device are taken, not
    their values), ``(shape, dtype)`` or ``(shape, dtype, device)`` specs,
    or anything else, passed as it is.  The trace runs under a fresh
    ``FakeTensorMode``: nothing is allocated on the card, no kernel
    launches, and every op's outputs are shape-checked, each Goursat solve
    as one op.  ``grad=True`` also traces ``torch.autograd.grad`` of the
    output with respect to the floating-point arguments (the JAX package's
    ``jax.value_and_grad(fn)``): the backward's ops and the recomputation
    inside ``torch.utils.checkpoint``.  The op counters of
    :mod:`repro_torch.core.dispatch` record nothing in it.

    The full Gram is ``(Bx, By)`` and the dense pairwise Δ stack
    ``(Bx, By, Lx, Ly)``: one prefix test catches both.  Pick ``Bx != By``
    and batch sizes distinct from L and d to avoid shape coincidences (the
    guard behind ``mmd2``'s streaming re-traces with bumped batch sizes to
    clear them).
    """
    offending = _dense_intermediates(fn, *args, gram_shape=gram_shape, grad=grad)
    if offending:
        bx, by = gram_shape
        raise StreamingViolation(
            f"streaming {what} materialises dense ({bx}, {by}) "
            f"intermediates: {sorted(set(offending))} — the full Gram "
            "(or pairwise Δ stack) must never exist; lower row_block or "
            "report a bug in repro_torch.core.gram")


def _dense_intermediates(fn, *args, gram_shape, grad: bool = False) -> list:
    """Shapes of every intermediate of the fake trace of ``fn(*args)``
    whose leading dims equal ``gram_shape``."""
    bx, by = gram_shape
    return [s for s in _traced_shapes(fn, args, grad)
            if len(s) >= 2 and s[0] == bx and s[1] == by]


def _traced_shapes(fn, args, grad: bool) -> list:
    """The output shapes of every op ``fn(*args)`` (and, with ``grad``,
    its backward) dispatches, traced on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.shapes += [tuple(t.shape) for t in tree_flatten(out)[0]
                            if isinstance(t, torch.Tensor)]
            return out

    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))

    def fake(a):
        if isinstance(a, torch.Tensor):
            a = (a.shape, a.dtype, a.device)
        elif not (isinstance(a, tuple) and len(a) in (2, 3)
                  and isinstance(a[1], torch.dtype)):
            return a
        t = torch.empty(tuple(a[0]), dtype=a[1], device=a[2] if len(a) == 3 else device)
        return t.requires_grad_() if grad and t.is_floating_point() else t

    rec = Shapes()
    with dispatch.paused_counters(), tf.lengths_validated(), \
            torch.inference_mode(False), torch.enable_grad(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        fargs = [fake(a) for a in args]
        with rec:
            out = fn(*fargs)
            leaves = [a for a in fargs if isinstance(a, torch.Tensor) and a.requires_grad]
            if grad and leaves and out.requires_grad:
                torch.autograd.grad(out, leaves, torch.ones_like(out), allow_unused=True)
    return rec.shapes


#: keys (shapes, dtypes, device, configs) whose streaming reduction passed
#: the guard
_stream_checked: set = set()


def _reduce_guard_key(X, Y, lens, names, kw) -> tuple:
    """A reduction's key: the shapes, dtypes and device of its arguments,
    and its configs by ``repr`` (a learnable ``RBF.sigma`` by its value)."""
    return (tuple(X.shape), str(X.dtype), str(X.device),
            None if Y is None else (tuple(Y.shape), str(Y.dtype)),
            tuple((tuple(a.shape), str(a.dtype)) for a in lens), tuple(names),
            tuple(sorted((k, repr(v)) for k, v in kw.items())))


def _guard_reduce(guard_args, **kw) -> None:
    """Run the streaming guard (value and gradient) once per key.

    A trace at the real batch sizes first and, only if it finds a
    ``(Bx, By)``-shaped intermediate, traces with the batch dims AND
    ``row_block`` bumped by one and by two.  A dense Gram or Δ stack tracks
    the batch dims and does not depend on ``row_block``, so it survives
    every bump.  A shape coincidence involves a size that does not track
    both bumped batch dims: a static size (a ragged pad width equal to
    ``Bx``, a PDE grid dim equal to ``By``) cannot match the batch at two
    bumps, and a block-derived size (the symmetric pair chunk
    ``row_block · Bx``, a block's row count) is pushed off the batch by the
    ``row_block`` bump, so both are cleared.  The Nyström candidate pool is
    held at the real call's size in the bumped traces: where it takes the
    whole batch (``FeatureConfig.pool_size``), its landmark Gram, of the
    pool's size by the method's design, is such a static size.  (The JAX
    guard lets the pool follow the batch and raises there.)
    """
    X, Y, lengths, lengths_y = guard_args
    if kw["symmetric"]:
        Y = None   # Y=X with symmetric=True: one batch
    named = [(n, torch.as_tensor(a)) for n, a in (("lengths", lengths),
                                                   ("lengths_y", lengths_y))
             if a is not None]
    names, lens = [n for n, _ in named], [a for _, a in named]
    key = _reduce_guard_key(X, Y, lens, names, kw)
    if key in _stream_checked:
        return
    n_arr = 1 if Y is None else 2

    feats = kw.get("features")
    pinned = {} if feats is None or feats.method != "nystroem" else dict(
        features=dataclasses.replace(feats, pool=feats.pool_size(X.shape[0])))

    def trace(bump):
        kwb = dict(kw, row_block=kw["row_block"] + bump, **(pinned if bump else {}))

        def red(*args):
            arrs, ls = args[:n_arr], args[n_arr:]
            return sigkernel_gram_reduce(*arrs, check_streaming=False,
                                         **dict(zip(names, ls)), **kwb)

        def spec(a):
            return (a.shape[0] + bump,) + tuple(a.shape[1:]), a.dtype, X.device

        args = [spec(X)] + ([] if Y is None else [spec(Y)]) + [spec(a) for a in lens]
        bx = X.shape[0] + bump
        by = bx if Y is None else Y.shape[0] + bump
        return _dense_intermediates(red, *args, gram_shape=(bx, by), grad=True), (bx, by)

    offending, (bx, by) = trace(0)
    if offending and trace(1)[0] and trace(2)[0]:
        raise StreamingViolation(
            f"streaming Gram reduction materialises dense ({bx}, {by}) "
            f"intermediates: {sorted(set(offending))} — the full Gram "
            "(or pairwise Δ stack) must never exist; lower row_block "
            "or report a bug in repro_torch.core.gram")
    _stream_checked.add(key)


@spans.spanned(spans.ENTRY_GRAM_REDUCE)
def sigkernel_gram_reduce(X: torch.Tensor, Y: Optional[torch.Tensor] = None, *,
                          include_diag: bool = True, backend: str = "auto",
                          row_block: Optional[int] = None,
                          symmetric: Optional[bool] = None, lengths=None,
                          lengths_y=None, transforms=None, grid=None,
                          static_kernel=None, launch=None,
                          features=None, error_budget=None,
                          check_streaming: bool = False) -> torch.Tensor:
    """Streaming ``Σ_{a,b} K[a, b]`` — the Gram-sum without the Gram.

    The workhorse of ``mmd2``/``scoring_rule`` with ``streaming=`` on: the
    sum is accumulated per row block (asymmetric) or per pair chunk
    (symmetric), each block under ``torch.utils.checkpoint``, so at most
    one block of PDE solves is alive at a time in the forward AND the
    backward (the backward recomputes each block instead of keeping its
    residuals).  The full (Bx, By) Gram and the pairwise Δ stack never
    exist.

    Args (beyond :func:`sigkernel_gram`'s):
      include_diag: symmetric reductions only — ``False`` drops the
        ``k(x_a, x_a)`` diagonal (the ``Σ − tr`` of the unbiased MMD) at no
        extra solves (off-diagonal pairs enter with weight 2, the diagonal
        with weight 0).
      row_block: at most ``row_block`` Gram rows (or ``row_block · Bx``
        symmetric pairs) in flight.  Default: ``launch.gram_row_block``,
        else the largest block that fits the pair-gather budget.
      features / error_budget: as in :func:`sigkernel_gram`; with a feature
        map active the reduction is feature algebra,
        ``⟨Σ_a phi(X)_a, Σ_b phi(Y)_b⟩`` (less ``Σ_a ‖phi_a‖²`` without the
        diagonal), and never forms a Gram.
      check_streaming: run the streaming guard
        (:func:`assert_streaming_reduction`, value and gradient, on fake
        tensors) on this reduction once per shape and config key before it
        runs, as ``mmd2`` / ``scoring_rule`` do whenever they stream.
        Skipped when one block covers the batch (the reduction is dense by
        construction), except on the feature path, which is checked
        whenever asked.

    Returns a 0-d tensor, differentiable with the exact one-pass backward.
    The guard leaves values, gradients, kernel launch counts and the op
    counters as they are without it.
    """
    if not include_diag and not (symmetric or (symmetric is None and Y is None)):
        raise ValueError("include_diag=False requires the symmetric "
                         "reduction (Y=None)")
    # the guard replays the padding itself: it takes the arguments as given
    guard_args = (X, Y, lengths, lengths_y)
    (X, Y, lengths, lengths_y, cfg, g, kernel, backend, symmetric,
     launch, feats) = _resolve_engine(X, Y, symmetric, lengths, lengths_y, transforms,
                                      grid, static_kernel, backend, launch, features,
                                      error_budget)
    guard = dict(include_diag=include_diag, backend=backend, symmetric=symmetric,
                 transforms=cfg, grid=g, static_kernel=kernel, launch=launch)
    if row_block is None:
        row_block = launch.gram_row_block
    if feats is not None:
        if check_streaming:
            _guard_reduce(guard_args, row_block=1 if row_block is None else row_block,
                          features=feats, **guard)
        phiX, phiY = _feature_maps(X, None if symmetric else Y, feats, cfg, g, kernel,
                                   lengths, lengths_y, launch)
        if symmetric:
            s = phiX.sum(dim=0)
            total = s @ s
            if not include_diag:   # ΣK − tr(K), in feature space
                total = total - (phiX * phiX).sum()
            return total
        return phiX.sum(dim=0) @ phiY.sum(dim=0)
    sX = _prepare(X, cfg, kernel, lengths)
    Bx, L, d = sX.shape
    if symmetric:
        rb = row_block if row_block is not None else _auto_row_block(Bx, L, d)
        streams = max(1, int(rb)) * Bx < Bx * (Bx + 1) // 2
    else:
        rb = row_block if row_block is not None else _auto_row_block(Y.shape[0], L, d)
        streams = max(1, int(rb)) < Bx
    if check_streaming and streams:
        _guard_reduce(guard_args, row_block=rb, **guard)
    if symmetric:
        return _reduce_symmetric(sX, kernel, backend, rb, g, include_diag, launch)
    sY = _prepare(Y, cfg, kernel, lengths_y)
    return _reduce_rows(sX, sY, kernel, backend, rb, g, launch)


def _reduce_symmetric(sX: torch.Tensor, kernel, backend: str, row_block: int, g,
                      include_diag: bool, launch=None) -> torch.Tensor:
    """Σ over the symmetric Gram via the upper triangle: off-diagonal pairs
    weighted 2, the diagonal 1 (or 0).  A Python loop needs no padding
    pairs: the last chunk is just shorter."""
    Bx = sX.shape[0]
    a_np, b_np = np.triu_indices(Bx)
    w = _upload(np.where(a_np == b_np, 1.0 if include_diag else 0.0, 2.0), sX.device,
                sX.dtype)
    a_idx = _upload(a_np, sX.device)
    b_idx = _upload(b_np, sX.device)
    chunk = max(1, int(row_block)) * Bx
    dispatch.record_pair_solves(a_np.size)

    def block(sx, a, b, wc):
        return (wc * _solve_pairs(sx[a], sx[b], kernel, backend, g, launch)).sum()

    if chunk >= a_np.size:
        return block(sX, a_idx, b_idx, w)
    return sum(checkpoint(block, sX, a, b, wc, use_reentrant=False)
               for a, b, wc in zip(a_idx.split(chunk), b_idx.split(chunk), w.split(chunk)))


def _reduce_rows(sX: torch.Tensor, sY: torch.Tensor, kernel, backend: str,
                 row_block: int, g, launch=None) -> torch.Tensor:
    """Σ over the (Bx, By) Gram, ``row_block`` rows at a time.  The JAX
    engine pads Bx to the block and masks the padded rows (zero increments
    give k = 1, not 0); a Python loop has no padded rows to mask."""
    Bx, By = sX.shape[0], sY.shape[0]
    rb = max(1, int(row_block))
    dispatch.record_pair_solves(Bx * By)

    def block(sxb, sy):
        return _gram_block(sxb, sy, kernel, backend, g, launch).sum()

    if rb >= Bx:
        return block(sX, sY)
    return sum(checkpoint(block, sxb, sY, use_reentrant=False) for sxb in sX.split(rb))
