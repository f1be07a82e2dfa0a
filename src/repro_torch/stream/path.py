"""Streaming ``Path`` engine: O(1) interval signatures over growing paths.

Counterpart of ``repro/stream/path.py``.  The signature of every prefix of
a path is computed once (one O(L) scan) and stored with its group inverse,
so every interval query is a single Chen combine of two stored rows:

* the prefix store is the library's own Horner stream scan
  (:func:`repro_torch.core.signature._signature_stream_from_increments`),
  so ``path.signature(0, j)`` is bit for bit the plain scan's
  ``signature(points[:j], backend="reference")``;
* ``S(x[i:j]) = S(x[:i])^{-1} ⊗ S(x[:j])``, with the inverses precomputed
  (:func:`repro_torch.core.tensoralg.sig_inverse`): a query costs
  O(sig_dim), whatever ``j - i`` (the scan and combine counters of
  :mod:`repro_torch.core.dispatch` audit it);
* ``update(new_points)`` scans only the new chunk and Chen-combines its
  prefixes onto the stored tip: O(chunk) work, no re-scan;
* ``evict(before=)`` rebases the surviving prefixes through the evicted
  tip's inverse: no increment is folded again.

The point and prefix buffers are padded to power-of-two buckets
(:func:`repro_torch.core.transforms.bucket_length`) along the capacity and
the appended chunk; edge padding (the last point repeated) makes the padded
increments exactly zero, Horner no-ops.  Growth doubles the capacity, so a
stream of n points is re-allocated O(log n) times.

Transforms: ``lead_lag`` composes (its increments are local); ``time_aug``
and ``basepoint`` are refused, since both belong to the whole path and not
to its intervals.

Every ``Path`` is immutable: ``update`` and ``evict`` return a new one.
Queries and updates are differentiable by autograd back to the points.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, List, Optional, Sequence, Union

import torch

from ..core import lyndon
from ..core import tensoralg as ta
from ..core import transforms as tf
from ..core.config import TransformPipeline
from ..core.dispatch import record_combines
from ..core.logsignature import MODES as _LOGSIG_MODES
from ..core.signature import _signature_stream_from_increments

#: calls of each batched operation (build, update, query, evict).  The JAX
#: package counts jit traces under the same names; the port has no trace
#: cache, so these count every call.
_TRACE_COUNTS: Dict[str, int] = {"build": 0, "update": 0, "query": 0, "evict": 0}


def trace_counts() -> Dict[str, int]:
    """Snapshot of the call counters (build / update / query / evict)."""
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    """Zero the call counters."""
    for k in _TRACE_COUNTS:
        _TRACE_COUNTS[k] = 0


def _check_pipeline(transforms: Optional[TransformPipeline]) -> TransformPipeline:
    if transforms is None:
        return TransformPipeline()
    if not isinstance(transforms, TransformPipeline):
        raise TypeError(f"transforms= expects a TransformPipeline, got "
                        f"{type(transforms).__name__}")
    if transforms.time_aug or transforms.basepoint:
        raise ValueError(
            "repro.Path supports lead_lag only: time_aug renormalises every "
            "increment whenever the path grows (the [t0, t1] grid spans the "
            "whole path) and basepoint belongs to the full path, not its "
            "intervals — incompatible with an incremental prefix store.  "
            "Add a physical time channel to the data instead")
    return transforms


def _int(v, what: str) -> int:
    try:
        return operator.index(v)
    except TypeError:
        raise ValueError(f"{what} must be a Python int, got {v!r}") from None


# ---------------------------------------------------------------------------
# the batched operations, shared by every Path
# ---------------------------------------------------------------------------

def _gather(store: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (..., M, S) store at ``idx``: (n,) shared across the batch
    or (..., n) per path; returns (..., n, S)."""
    if idx.dim() == 1:
        return store.index_select(-2, idx)
    tgt = (*store.shape[:-2], idx.shape[-1], store.shape[-1])
    return torch.gather(store, -2, idx[..., :, None].expand(tgt))


def _pad_edge(t: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat the last row along axis -2 ``n`` more times."""
    if n == 0:
        return t
    return torch.cat([t, t[..., -1:, :].expand(*t.shape[:-2], n, t.shape[-1])], dim=-2)


def _interval_kernel(prefix: torch.Tensor, inv_prefix: torch.Tensor, ql: torch.Tensor,
                     qr: torch.Tensor, *, d: int, depth: int) -> torch.Tensor:
    """Signatures of the intervals [ql, qr) (n,) of transformed increments:
    one batched Chen combine of 2n stored rows, whatever the widths."""
    _TRACE_COUNTS["query"] += 1
    record_combines(ql.shape[-1])
    q_right = _gather(prefix, qr - 1)
    inv_left = _gather(inv_prefix, (ql - 1).clamp_min(0))
    inv_left = torch.where((ql > 0)[..., None], inv_left, inv_left.new_zeros(()))
    return ta.chen(inv_left, q_right, d, depth)


def _build_kernel(points: torch.Tensor, *, depth: int, lead_lag: bool):
    """Prefix store of an edge-padded point buffer (..., C, d):
    (Q_1..Q_M, their inverses).  Past the true length the prefixes repeat
    the tip (the padded increments are zero)."""
    _TRACE_COUNTS["build"] += 1
    z = points[..., 1:, :] - points[..., :-1, :]
    z = tf.transform_increments(z, False, lead_lag)
    prefix = _signature_stream_from_increments(z, depth)
    return prefix, ta.sig_inverse(prefix, z.shape[-1], depth)


def _update_kernel(points: torch.Tensor, prefix: torch.Tensor, inv_prefix: torch.Tensor,
                   length: torch.Tensor, chunk: torch.Tensor, k: torch.Tensor, *,
                   depth: int, lead_lag: bool):
    """Append an edge-padded chunk: scan the chunk, Chen onto the tip.

    ``points`` (..., C, d), ``chunk`` (..., kc, d); ``length`` / ``k``
    integer tensors broadcastable to the batch: the true point count so far
    and the chunk's true size (``k = 0`` makes the call a no-op for that
    member: the coalesced update's padding).  The only scan is over the
    chunk; the stored prefixes are extended by batched Chen combines.
    Returns the new (points, prefix, inv_prefix).
    """
    _TRACE_COUNTS["update"] += 1
    f = 2 if lead_lag else 1
    batch = points.shape[:-2]
    C, kc, M, S = points.shape[-2], chunk.shape[-2], prefix.shape[-2], prefix.shape[-1]
    dev = points.device
    length = length.to(dev, torch.int64).expand(batch)
    k = k.to(dev, torch.int64).expand(batch)

    # chunk increments anchored at the current tip; rows at or past the
    # chunk's true size are zero (edge padding; the mask covers k = 0)
    last = torch.gather(points, -2, (length - 1)[..., None, None].expand(
        *batch, 1, points.shape[-1]))
    z = torch.diff(torch.cat([last, chunk], dim=-2), dim=-2)
    valid = torch.arange(kc, device=dev) < k[..., None]
    z = torch.where(valid[..., None], z, z.new_zeros(()))
    z = tf.transform_increments(z, False, lead_lag)
    d_t, mc = z.shape[-1], z.shape[-2]

    # O(chunk): the chunk's own prefixes and their inverses
    s_chunk = _signature_stream_from_increments(z, depth)
    inv_chunk = ta.sig_inverse(s_chunk, d_t, depth)

    # O(1) a new step: splice onto the stored tip by Chen's identity
    m = f * (length - 1)                                   # steps so far
    at_tip = (m - 1)[..., None, None].expand(*batch, 1, S)
    q_m = torch.gather(prefix, -2, at_tip).expand(s_chunk.shape)
    inv_q_m = torch.gather(inv_prefix, -2, at_tip).expand(s_chunk.shape)
    new_q = ta.chen(q_m, s_chunk, d_t, depth)
    new_inv = ta.chen(inv_chunk, inv_q_m, d_t, depth)      # (ab)⁻¹ = b⁻¹a⁻¹
    record_combines(2 * mc)

    # the mc new prefixes go to offset m, the chunk's points to offset length
    src = torch.arange(M, device=dev) - m[..., None]
    on = (src >= 0) & (src < mc)
    src = src.clamp(0, mc - 1)[..., None].expand(*batch, M, S)
    prefix = torch.where(on[..., None], torch.gather(new_q, -2, src), prefix)
    inv_prefix = torch.where(on[..., None], torch.gather(new_inv, -2, src), inv_prefix)
    psrc = torch.arange(C, device=dev) - length[..., None]
    pon = (psrc >= 0) & (psrc < kc)
    psrc = psrc.clamp(0, kc - 1)[..., None].expand(*batch, C, points.shape[-1])
    points = torch.where(pon[..., None], torch.gather(chunk, -2, psrc), points)
    return points, prefix, inv_prefix


def _evict_kernel(points: torch.Tensor, prefix: torch.Tensor, length: int, e: int, *,
                  C: int, M: int, f: int, d: int, depth: int):
    """Drop the first ``e`` points by a group-inverse splice, no re-scan.

    The evicted prefix ``Q_{f·e}`` is a pivot: every surviving prefix
    becomes ``Q_{f·e}⁻¹ ⊗ Q_{f·e+k}`` (one batched Chen combine over the
    gathered rows), and the inverse store is the group inverse of the new
    prefixes.  ``C``/``M`` are the shrunken capacities; gathers clip at the
    true tip, so the tail repeats it as a fresh build's would.

    Both inverses are taken from the stored prefixes, not read from the
    inverse store as the JAX package does: a stored prefix carries the
    rounding of the products that made it, and its own inverse cancels that
    to first order, while the stored inverse (made by another chain of
    products) does not.  Read from the store, the error grows by a constant
    factor with every eviction (about 2 a step at depth 3 on unit-scale
    random walks: 1e-2 relative in float32 after 24 evictions); taken from
    the prefixes, it stays at the rounding of one splice.
    """
    _TRACE_COUNTS["evict"] += 1
    dev = points.device
    new_points = _gather(points, (e + torch.arange(C, device=dev)).clamp(0, length - 1))
    t = f * e                                              # transformed pivot step
    q = _gather(prefix, (t + torch.arange(M, device=dev)).clamp(0, f * (length - 1) - 1))
    piv_i = ta.sig_inverse(_gather(prefix, torch.tensor([t - 1], device=dev)), d, depth)
    new_prefix = ta.chen(piv_i.expand(q.shape), q, d, depth)
    record_combines(M)
    return new_points, new_prefix, ta.sig_inverse(new_prefix, d, depth)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RollingConfig:
    """Rolling-window query plan: ``window`` points every ``stride`` points.
    ``window`` counts points, so the smallest is 2 (one increment)."""

    window: int
    stride: int = 1

    def __post_init__(self):
        for name, lo in (("window", 2), ("stride", 1)):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < lo:
                raise ValueError(
                    f"RollingConfig.{name} must be a Python int >= {lo}, got {v!r}")

    def num_windows(self, length: int) -> int:
        """How many full windows fit in a ``length``-point path."""
        if length < self.window:
            return 0
        return (length - self.window) // self.stride + 1


# ---------------------------------------------------------------------------
# Path
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Path:
    """A (possibly growing) path with precomputed per-prefix signatures.

    Build with :meth:`from_points`.  ``points`` (..., C, d) is the bucketed
    point buffer; ``prefix`` / ``inv_prefix`` (..., M, sig_dim) hold
    ``Q_m``, the signature of the first m transformed increments, and its
    group inverse; ``length`` is the true point count (every path of a
    batch shares it; buffer content past it is unspecified).  ``depth``,
    the (lead-lag-only) ``transforms`` and the optional ``retention`` cap
    (:meth:`update` evicts the oldest points beyond it) complete it.
    """

    points: torch.Tensor
    prefix: torch.Tensor
    inv_prefix: torch.Tensor
    length: int
    depth: int
    transforms: TransformPipeline = TransformPipeline()
    retention: Optional[int] = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_points(cls, points, depth: int, *,
                    transforms: Optional[TransformPipeline] = None,
                    retention: Optional[int] = None) -> "Path":
        """Build the prefix store for ``points`` (..., L, d), L ≥ 2: one
        O(L) Horner stream scan over the buffer padded to its power-of-two
        capacity.  ``retention=n`` caps the stored history at ``n`` points
        (the initial points must fit it)."""
        transforms = _check_pipeline(transforms)
        if retention is not None and (not isinstance(retention, int)
                                      or isinstance(retention, bool) or retention < 2):
            raise ValueError(
                f"retention must be None or a Python int >= 2 (a path keeps "
                f"at least one increment), got {retention!r}")
        points = torch.as_tensor(points)
        if points.dim() < 2:
            raise ValueError(
                f"Path.from_points expects (..., L, d) points, got shape "
                f"{tuple(points.shape)}")
        L = points.shape[-2]
        if L < 2:
            raise ValueError(f"Path needs at least 2 points (one increment), got L={L}")
        if retention is not None and L > retention:
            raise ValueError(
                f"initial points ({L}) exceed retention={retention}; slice "
                f"the history yourself — eviction applies to updates")
        if not (isinstance(depth, int) and not isinstance(depth, bool) and depth >= 1):
            raise ValueError(f"depth must be a Python int >= 1, got {depth!r}")
        points = _pad_edge(points, tf.bucket_length(L) - L)
        prefix, inv = _build_kernel(points, depth=depth, lead_lag=transforms.lead_lag)
        return cls(points=points, prefix=prefix, inv_prefix=inv, length=L, depth=depth,
                   transforms=transforms, retention=retention)

    # -- shape facts --------------------------------------------------------

    @property
    def d(self) -> int:
        """Raw channel count of the stored points."""
        return self.points.shape[-1]

    @property
    def transformed_d(self) -> int:
        """Channel count the signatures are computed over."""
        return self.transforms.transformed_dim(self.d)

    @property
    def capacity(self) -> int:
        """Point capacity of the buffers (the current power-of-two bucket)."""
        return self.points.shape[-2]

    @property
    def sig_dim(self) -> int:
        """Flat signature width of every query result."""
        return self.prefix.shape[-1]

    @property
    def _f(self) -> int:
        """Transformed increments a raw increment (2 under lead-lag)."""
        return 2 if self.transforms.lead_lag else 1

    def __len__(self) -> int:
        return self.length

    # -- queries ------------------------------------------------------------

    def _check_interval(self, i, j):
        i = _int(i, "interval start i")
        j = self.length if j is None else _int(j, "interval end j")
        if i < 0 or j - i < 2 or j > self.length:
            raise ValueError(
                f"interval [{i}, {j}) must satisfy 0 <= i <= j-2 and j <= length "
                f"({self.length}) — a signature needs at least one increment")
        return i, j

    def signature(self, i: int = 0, j: Optional[int] = None) -> torch.Tensor:
        """Signature of ``points[i:j]`` — one Chen combine, no re-scan.

        ``j`` defaults to the length.  ``i == 0`` returns the stored prefix,
        bit for bit the plain scan of ``points[:j]``; other intervals are
        exact group arithmetic, a few ULPs from a fresh recompute."""
        i, j = self._check_interval(i, j)
        f = self._f
        if i == 0:
            return self.prefix[..., f * (j - 1) - 1, :]
        dev = self.prefix.device
        return _interval_kernel(self.prefix, self.inv_prefix,
                                torch.tensor([f * i], device=dev),
                                torch.tensor([f * (j - 1)], device=dev),
                                d=self.transformed_d, depth=self.depth)[..., 0, :]

    def logsignature(self, i: int = 0, j: Optional[int] = None, *,
                     mode: str = "lyndon") -> torch.Tensor:
        """Log-signature of ``points[i:j]``: the interval signature (one Chen
        combine) through ``tensor_log`` and the Lyndon projection."""
        if mode not in _LOGSIG_MODES:
            raise ValueError(f"mode must be one of {_LOGSIG_MODES}, got {mode!r}")
        flat = ta.tensor_log(self.signature(i, j), self.transformed_d, self.depth)
        if mode == "expand":
            return flat
        return lyndon.compress(flat, self.transformed_d, self.depth, mode)

    def rolling(self, window: Union[int, RollingConfig], *, stride: int = 1) -> torch.Tensor:
        """Signatures of every full ``window``-point window, (..., n, sig_dim);
        window ``w`` starts at point ``w·stride``.  One batched Chen
        combine over all windows (``window`` may be a :class:`RollingConfig`,
        whose stride wins).  The JAX package pads the window count to a
        power of two to share a jit trace; with no trace to share, the port
        combines exactly the n windows."""
        cfg = window if isinstance(window, RollingConfig) \
            else RollingConfig(window=window, stride=stride)
        n = cfg.num_windows(self.length)
        if n < 1:
            raise ValueError(
                f"no full {cfg.window}-point window fits in a {self.length}-point path")
        f = self._f
        starts = torch.arange(n, device=self.prefix.device) * cfg.stride
        return _interval_kernel(self.prefix, self.inv_prefix, f * starts,
                                f * (starts + cfg.window - 1), d=self.transformed_d,
                                depth=self.depth)

    # -- incremental extension ----------------------------------------------

    def update(self, new_points) -> "Path":
        """Extend the path with ``new_points`` (..., k, d), k ≥ 1.

        O(chunk): the chunk (edge-padded to its power-of-two bucket) is
        scanned and Chen-combined onto the stored tip.  Buffers that run
        out grow to the next power-of-two bucket first.  With a retention
        cap, the oldest points beyond it are evicted after."""
        new_points = torch.as_tensor(new_points, device=self.points.device)
        if new_points.dim() < 2 or new_points.shape[-1] != self.d:
            raise ValueError(f"update expects (..., k, {self.d}) new points, got shape "
                             f"{tuple(new_points.shape)}")
        k = new_points.shape[-2]
        if k < 1:
            raise ValueError("update needs at least one new point")
        L = self.length
        kc = tf.bucket_length(k, minimum=1)
        new_points = _pad_edge(new_points, kc - k)
        points, prefix, inv_prefix = self.points, self.prefix, self.inv_prefix
        if L + kc > self.capacity:
            grow = tf.bucket_length(L + kc) - self.capacity
            points = _pad_edge(points, grow)
            prefix = _pad_edge(prefix, self._f * grow)
            inv_prefix = _pad_edge(inv_prefix, self._f * grow)
        dev = points.device
        points, prefix, inv_prefix = _update_kernel(
            points, prefix, inv_prefix, torch.tensor(L, device=dev), new_points,
            torch.tensor(k, device=dev), depth=self.depth, lead_lag=self.transforms.lead_lag)
        out = dataclasses.replace(self, points=points, prefix=prefix,
                                  inv_prefix=inv_prefix, length=L + k)
        if self.retention is not None and L + k > self.retention:
            out = out.evict(before=L + k - self.retention)
        return out

    # -- eviction ------------------------------------------------------------

    def evict(self, *, before: int) -> "Path":
        """Drop ``points[:before]`` by group splices, no re-scan.

        Queries on the new path are in its own coordinates (old point
        ``before + i`` is new point ``i``) and agree with a fresh build to a
        few ULPs.  Buffers shrink to the new length's bucket; at least 2
        points must survive."""
        if not isinstance(before, int) or isinstance(before, bool) or before < 0:
            raise ValueError(f"evict(before=) must be a Python int >= 0, got {before!r}")
        L = self.length
        if before == 0:
            return self
        if before > L - 2:
            raise ValueError(
                f"evict(before={before}) would leave fewer than 2 of the {L} points — "
                f"a path keeps at least one increment")
        f = self._f
        C = tf.bucket_length(L - before)
        points, prefix, inv_prefix = _evict_kernel(
            self.points, self.prefix, L, before, C=C, M=f * (C - 1), f=f,
            d=self.transformed_d, depth=self.depth)
        return dataclasses.replace(self, points=points, prefix=prefix,
                                   inv_prefix=inv_prefix, length=L - before)


# ---------------------------------------------------------------------------
# coalesced updates: the serving loop's hot path
# ---------------------------------------------------------------------------

def coalesced_update(paths: Sequence[Path], chunks: Sequence) -> List[Path]:
    """Apply one append a path as a single batched update.

    All paths must share ``(capacity, d, depth, transforms)`` and be
    unbatched ((C, d) points).  Chunks are padded to the group's common
    chunk bucket; the group is padded to a power-of-two size with no-op
    (``k = 0``) members, as the JAX package does.  A path whose chunk does
    not fit its capacity is refused (``Path.update`` grows it).  Returns the
    updated paths, in order.
    """
    if len(paths) != len(chunks):
        raise ValueError(f"coalesced_update got {len(paths)} paths but {len(chunks)} chunks")
    if not paths:
        return []
    p0 = paths[0]
    if p0.points.dim() != 2:
        raise ValueError(
            "coalesced_update expects unbatched paths ((C, d) points); "
            "batch them through the group axis instead")
    key0 = (p0.capacity, p0.d, p0.depth, p0.transforms)
    dev = p0.points.device
    chunks = [torch.as_tensor(c, device=dev) for c in chunks]
    ks = [c.shape[-2] for c in chunks]
    kc = tf.bucket_length(max(ks), minimum=1)
    padded = []
    for p, c, k in zip(paths, chunks, ks):
        if c.dim() != 2 or c.shape[-1] != p0.d:
            raise ValueError(f"chunk shape {tuple(c.shape)} does not match (k, {p0.d})")
        if (p.capacity, p.d, p.depth, p.transforms) != key0:
            raise ValueError(
                "coalesced_update needs a homogeneous group "
                "(capacity, d, depth, transforms); group before calling")
        if p.length + kc > p.capacity:
            raise ValueError(
                f"path at length {p.length} cannot take a {kc}-bucket chunk within "
                f"capacity {p.capacity}; grow it first (Path.update does this)")
        padded.append(_pad_edge(c, kc - k))

    G = len(paths)
    pad = tf.bucket_length(G, minimum=1) - G

    def stack(xs):
        return torch.stack(list(xs) + [xs[0]] * pad)

    points, prefix, inv = _update_kernel(
        stack([p.points for p in paths]), stack([p.prefix for p in paths]),
        stack([p.inv_prefix for p in paths]),
        torch.tensor([p.length for p in paths] + [paths[0].length] * pad, device=dev),
        stack(padded), torch.tensor(ks + [0] * pad, device=dev),
        depth=p0.depth, lead_lag=p0.transforms.lead_lag)
    out: List[Path] = []
    for g, (p, k) in enumerate(zip(paths, ks)):
        new = dataclasses.replace(p, points=points[g], prefix=prefix[g],
                                  inv_prefix=inv[g], length=p.length + k)
        if p.retention is not None and new.length > p.retention:
            new = new.evict(before=new.length - p.retention)
        out.append(new)
    return out
