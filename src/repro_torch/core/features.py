"""Sub-quadratic signature-kernel approximations as feature maps.

Counterpart of ``repro/core/features.py``.  Each map gives features
``phi(X) ∈ R^{B×F}`` whose inner products approximate the exact Gram,
``K[a, b] ≈ ⟨phi(X)_a, phi(Y)_b⟩``, so the losses become O(B·F):

``"rff"`` — random Fourier signature features
    The static-kernel lift becomes its random-Fourier feature map (exact
    for :class:`Linear`, Bochner ``cos(x·W + b)`` features for
    :class:`RBF`), and the lifted path's truncated signature is sketched by
    ``rank`` tensor random projections, one scan over the increments each.
    Feature dimension ``1 + rank·depth``; no PDE solves.
``"nystroem"`` — landmark low-rank approximation
    ``rank`` landmarks are picked from a ``pool``-sized random subset by
    pivoted Cholesky on the exact pool Gram; ``phi(A) = K(A, Z)·L_w^{-T}``
    with ``L_w = chol(K(Z, Z) + jitter·I)``.  Costs pool² + B·rank exact
    solves, through the exact engine's ``"auto"`` backend (on the card, the
    Goursat kernels).

Randomness: the JAX package draws from a ``jax.random`` key; here
:class:`FeatureConfig` holds an integer ``seed`` and every draw comes from
a ``torch.Generator`` seeded with it on the paths' device.  Each map is split in two: a function that makes the draws
(:func:`rff_draws`, :func:`nystroem_pool`) and one that takes them as
tensors (:func:`rff_features` with ``draws=``, the Gram engine's
``_nystroem_maps`` with ``pool_idx=``), so a caller can feed draws made
elsewhere.  Both maps are differentiable by autograd; Nyström's pivot
selection runs under ``torch.no_grad()`` on the device, while everything
gathered at the pivots stays on the tape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from . import transforms as tf
from .config import RBF, Linear
from repro_torch.kernels._ops import define

#: methods a FeatureConfig may name (also the dispatch backend names)
METHODS = ("rff", "nystroem")

#: floor of a pivot's residual before the sqrt: keeps the selection finite
#: when the residual underflows at full rank
_PIVOT_TINY = 1e-12


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Configuration of one approximate signature-kernel feature map.

    Attributes:
      method: ``"rff"`` (no PDE solves) or ``"nystroem"`` (O(B·rank) exact
        solves).
      rank: projection draws (rff; feature dim ``1 + rank·depth``) or
        landmarks (nystroem; feature dim ``rank``, clamped to the pool).
      seed: seed of the ``torch.Generator`` the draws come from (on the
        paths' device); the same seed gives the same map.
      depth: rff only — truncation depth of the signature sketch.
      lift_dim: rff only — Bochner dimension m of an RBF lift.
      pool: nystroem only — candidate-subset size; 0 means
        ``min(B, 4·rank)``.
      jitter: nystroem only — diagonal regulariser of the landmark Gram.
    """

    method: str = "rff"
    rank: int = 32
    seed: int = 0
    depth: int = 4
    lift_dim: int = 64
    pool: int = 0
    jitter: float = 1e-6

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(
                f"FeatureConfig.method must be one of {METHODS}, got "
                f"{self.method!r}")
        for name, lo in (("rank", 1), ("depth", 1), ("lift_dim", 1),
                         ("pool", 0), ("seed", 0)):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < lo:
                raise ValueError(
                    f"FeatureConfig.{name} must be a Python int >= {lo}, "
                    f"got {v!r}")

    def feature_dim(self, batch: int) -> int:
        """Feature dimension F of ``phi`` for a batch of ``batch``."""
        if self.method == "rff":
            return 1 + self.rank * self.depth
        return min(self.rank, self.pool_size(batch))

    def pool_size(self, batch: int) -> int:
        """Nyström candidate-pool size for a batch of ``batch``."""
        pool = self.pool if self.pool else 4 * self.rank
        return max(1, min(int(pool), int(batch)))


def resolve_features(features) -> Optional[FeatureConfig]:
    """Type-check the ``features=`` argument of the Gram entry points."""
    if features is None or isinstance(features, FeatureConfig):
        return features
    raise TypeError(
        f"features= expects a FeatureConfig, got {type(features).__name__}")


def _generator(feats: FeatureConfig, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(feats.seed)
    return gen


# ---------------------------------------------------------------------------
# random Fourier signature features
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RFFDraws:
    """The draws of one RFF map: an RBF lift's standard-normal frequencies
    ``w`` (d, m) and phases ``b`` (m,) in [0, 2π) (both None for
    :class:`Linear`), and the projections ``proj`` (rank, depth, m')."""

    w: Optional[torch.Tensor]
    b: Optional[torch.Tensor]
    proj: torch.Tensor


def rff_draws(feats: FeatureConfig, kernel, d: int, *, device,
              dtype=torch.float32) -> RFFDraws:
    """Make the draws of the RFF map of ``feats`` for ``d``-channel
    (transformed) points, from a generator seeded with ``feats.seed`` on
    ``device``."""
    kw = dict(generator=_generator(feats, device), dtype=dtype, device=device)
    if isinstance(kernel, Linear):
        w = b = None
        m = d
    elif isinstance(kernel, RBF):
        w = torch.randn((d, feats.lift_dim), **kw)
        b = torch.rand((feats.lift_dim,), **kw) * (2.0 * math.pi)
        m = feats.lift_dim
    else:
        raise ValueError(f"rff features support Linear/RBF static kernels, got "
                         f"{type(kernel).__name__}")
    return RFFDraws(w, b, torch.randn((feats.rank, feats.depth, m), **kw))


def _rff_lift(points: torch.Tensor, kernel, draws: RFFDraws) -> torch.Tensor:
    """Pointwise feature map of the static-kernel lift (..., L, d) -> (..., L, m').

    ``Linear(scale)`` lifts exactly (``√scale·x``); ``RBF(sigma)`` gives
    ``√(2/m)·cos(x·W/σ + b)``, with ``sigma`` on the tape."""
    if isinstance(kernel, Linear):
        scale = torch.as_tensor(kernel.scale, dtype=points.dtype, device=points.device)
        return points * torch.sqrt(scale)
    sigma = torch.as_tensor(kernel.sigma, dtype=points.dtype, device=points.device)
    w = draws.w / sigma
    m = w.shape[-1]
    return math.sqrt(2.0 / m) * torch.cos(points @ w + draws.b)


def _sig_projection_scan(inc: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Tensor-random-projected signature levels of an increment stream.

    inc (B, L, m), proj (rank, depth, m) -> (B, rank, depth): entry
    ``[b, r, n-1]`` is the level-n signature of the piecewise-linear path
    contracted with ``u_1 ⊗ … ⊗ u_n``.  Each step folds a whole segment in:
    ``new_P[k] = Σ_{j≤k} P[j]·⟨u_{j+1}, dz⟩ ⋯ ⟨u_k, dz⟩ / (k−j)!``.
    Trailing zero increments (ragged padding) are exact no-ops.

    One ``repro_torch::rff_scan`` op (:class:`_ProjectionScan` carries its
    gradient), so a trace on fake tensors sees one op, not the L steps;
    projections that require grad take the steps under autograd.
    """
    if torch.is_grad_enabled() and proj.requires_grad:
        return _projection_scan(inc, proj)
    return _ProjectionScan.apply(inc, proj)


def _projection_scan(inc: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """The steps of :func:`_sig_projection_scan`."""
    B = inc.shape[0]
    rank, depth, _ = proj.shape
    s = torch.einsum("blm,rkm->lbrk", inc, proj)       # ⟨proj[r, k], dz_l⟩
    p = torch.cat([inc.new_ones((B, rank, 1)), inc.new_zeros((B, rank, depth))], dim=-1)
    for s_l in s:
        new = [p[..., 0]]
        for k in range(1, depth + 1):
            acc = p[..., k]
            prod = None
            fact = 1.0
            for j in range(k - 1, -1, -1):              # prod = s_{j+1} ⋯ s_k
                prod = s_l[..., j] if prod is None else prod * s_l[..., j]
                fact *= (k - j)
                acc = acc + p[..., j] * prod * (1.0 / fact)
            new.append(acc)
        p = torch.stack(new, dim=-1)
    return p[..., 1:]


rff_scan = define(
    "rff_scan", "(Tensor inc, Tensor proj) -> Tensor",
    lambda inc, proj: inc.new_empty(inc.shape[0], proj.shape[0], proj.shape[1]),
    CompositeExplicitAutograd=lambda inc, proj: _projection_scan(inc, proj).contiguous())


class _ProjectionScan(torch.autograd.Function):
    """:data:`rff_scan` with its gradient in the increments.  The backward
    runs the same steps again under autograd from the saved increments, so
    the gradient is autograd's through the steps bit for bit; on a fake
    tensor (a trace) it gives the gradient's shape alone."""

    @staticmethod
    def forward(ctx, inc, proj):
        ctx.save_for_backward(inc, proj)
        return rff_scan(inc, proj)

    @staticmethod
    def backward(ctx, g):
        inc, proj = ctx.saved_tensors
        if is_fake(g):
            return torch.empty_like(inc), None
        with torch.enable_grad():
            leaf = inc.detach().requires_grad_()
            d, = torch.autograd.grad(_projection_scan(leaf, proj), leaf, g)
        return d, None


def rff_features(paths: torch.Tensor, feats: FeatureConfig, pipeline, kernel,
                 lengths=None, draws: Optional[RFFDraws] = None) -> torch.Tensor:
    """Random Fourier signature features phi(paths) ∈ (B, 1 + rank·depth).

    ``⟨phi(x), phi(y)⟩`` is an unbiased estimate of the depth-truncated
    signature kernel of the transformed, lifted paths.  ``draws`` default
    to :func:`rff_draws` of ``feats`` on the paths' device; pass the same
    draws for both sides of a Gram.  Ragged ``lengths=`` padding gives
    zero increments, so its content (even NaN) never reaches the features.
    """
    if paths.dim() != 3:
        raise ValueError(f"rff_features expects (B, L, d) paths, got {tuple(paths.shape)}")
    points = tf.transform_path(paths, pipeline, lengths, align="start")
    if draws is None:
        draws = rff_draws(feats, kernel, points.shape[-1], dtype=points.dtype,
                          device=points.device)
    z = _rff_lift(points, kernel, draws)
    inc = z[:, 1:] - z[:, :-1]
    levels = _sig_projection_scan(inc, draws.proj.to(inc.dtype))
    flat = levels.reshape(inc.shape[0], feats.rank * feats.depth)
    flat = flat / torch.sqrt(torch.tensor(feats.rank, dtype=flat.dtype, device=flat.device))
    return torch.cat([flat.new_ones((inc.shape[0], 1)), flat], dim=-1)


# ---------------------------------------------------------------------------
# Nyström: landmark selection (pivoted Cholesky) and the feature solve
# ---------------------------------------------------------------------------

def nystroem_pool(feats: FeatureConfig, batch: int, *, device) -> torch.Tensor:
    """The Nyström candidate pool: ``pool_size(batch)`` indices of a random
    permutation of the batch, from a generator seeded with ``feats.seed`` on
    ``device``."""
    perm = torch.randperm(batch, generator=_generator(feats, device), device=device)
    return perm[:feats.pool_size(batch)]


def pivoted_cholesky(G: torch.Tensor, rank: int):
    """Greedy rank-``rank`` pivoted Cholesky of a PSD Gram ``G`` (n, n).

    Returns ``(piv, resid)``: the pivots (rank,) int64 in selection order
    and the residual diagonal's trace after each step.  Runs under
    ``torch.no_grad()`` on ``G``'s device: the pivot of each step stays a
    device tensor (``argmax``), never read on the host.
    """
    n = G.shape[0]
    if not 1 <= rank <= n:
        raise ValueError(f"pivoted_cholesky rank must be in [1, {n}], got {rank}")
    with torch.no_grad():
        Gs = G.detach()
        d = torch.diagonal(Gs).clone()
        L = Gs.new_zeros((n, rank))
        piv = torch.empty(rank, dtype=torch.int64, device=G.device)
        resid = Gs.new_empty(rank)
        for j in range(rank):
            p = torch.argmax(d).reshape(1)
            dp = d.index_select(0, p).clamp_min(_PIVOT_TINY)
            col = Gs.index_select(1, p)[:, 0] - L @ L.index_select(0, p)[0]
            lj = col / torch.sqrt(dp)
            L[:, j] = lj
            d = torch.clamp_min(d - lj * lj, 0.0).index_fill(0, p, 0.0)
            piv[j] = p[0]
            resid[j] = d.sum()
    return piv, resid


def nystroem_factor(G_landmarks: torch.Tensor, jitter) -> torch.Tensor:
    """Lower Cholesky factor of the landmark Gram ``W + jitter·I``."""
    W = G_landmarks
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    return torch.linalg.cholesky(W + torch.as_tensor(jitter, dtype=W.dtype,
                                                     device=W.device) * eye)


def nystroem_phi(K_cross: torch.Tensor, Lw: torch.Tensor) -> torch.Tensor:
    """Nyström features from an exact cross-Gram: ``K(A, Z)·L_w^{-T}``."""
    return torch.linalg.solve_triangular(Lw, K_cross.T, upper=False).T
