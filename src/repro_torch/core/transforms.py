"""Path-to-path transformations (pySigLib §4) in PyTorch.

Counterpart of ``repro/core/transforms.py``.  Two views:

* ``time_augment`` / ``lead_lag`` / ``basepoint`` materialise the
  transformed *path* (for oracles and the Δ-from-Gram route of non-linear
  lifts);
* ``transform_increments`` / ``pipeline_increments`` produce the
  transformed path's *increments* directly from the raw ones, which is all
  the linear signature kernel consumes.

The pipeline order is basepoint → lead-lag → time-aug.  Lead-lag: points
x_0..x_{L-1} give 2L-1 points whose increments alternate (dx_k, 0) then
(0, dx_k).

Ragged batches: an optional ``lengths`` tensor of per-path point counts
(2 ≤ lengths[b] ≤ L) treats each path as truncated to its own length; the
padding content never matters.  ``align="end"`` moves each path's valid
stream to the end of the axis, so that its padding becomes leading zero Δ
rows and columns, which leave the Goursat boundary of ones exactly intact:
the far-corner readout is then the true ``(len_x, len_y)`` corner.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

#: time grids are built in at least this dtype and cast
_GRID_DTYPE = torch.float32

#: ragged length axes are padded to at least this many points, then to the
#: next power of two
_MIN_BUCKET = 8


# ---------------------------------------------------------------------------
# ragged-batch plumbing
# ---------------------------------------------------------------------------

_validated = threading.local()


@contextlib.contextmanager
def lengths_validated():
    """Within, ``lengths=`` values are taken as checked: a trace of fake
    tensors (the streaming guard of ``core/gram.py``) has no values to read,
    and its caller checked the real lengths.  Dtypes and shapes are still
    checked."""
    prev = getattr(_validated, "on", False)
    _validated.on = True
    try:
        yield
    finally:
        _validated.on = prev


def _check_lengths(lengths, batch_shape, L: int, device=None) -> torch.Tensor:
    """Validate per-path lengths against a (..., L, d) batch."""
    arr = torch.as_tensor(lengths, device=device)
    if arr.dtype.is_floating_point or arr.dtype.is_complex or arr.dtype == torch.bool:
        raise TypeError(
            f"lengths= must be integer-typed per-path point counts, got "
            f"dtype {arr.dtype}")
    if tuple(arr.shape) != tuple(batch_shape):
        raise ValueError(
            f"lengths shape {tuple(arr.shape)} must equal the path batch shape "
            f"{tuple(batch_shape)} (one true length per path)")
    arr = arr.to(torch.int64)
    if arr.numel() and not getattr(_validated, "on", False):
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 2:
            raise ValueError(
                f"lengths= entries must be >= 2 (a path needs at least one "
                f"increment), got min {lo}")
        if hi > L:
            raise ValueError(
                f"lengths= entries must be <= the padded length axis "
                f"({L}), got max {hi}")
    return arr


def bucket_length(L: int, minimum: int = _MIN_BUCKET) -> int:
    """Bucketed (padded) length for a ragged batch: next power of two ≥ L."""
    b = max(int(L), int(minimum))
    return 1 << (b - 1).bit_length()


def pad_ragged(path: torch.Tensor, lengths, *, bucket: bool = True,
               minimum: int = _MIN_BUCKET):
    """``(path, lengths)`` with the length axis padded (last row repeated)
    up to :func:`bucket_length` and ``lengths`` as an int64 tensor on the
    path's device."""
    lengths = _check_lengths(lengths, path.shape[:-2], path.shape[-2], path.device)
    if bucket:
        L = path.shape[-2]
        target = bucket_length(L, minimum)
        if target > L:
            last = path[..., -1:, :].expand(*path.shape[:-2], target - L,
                                            path.shape[-1])
            path = torch.cat([path, last], dim=-2)
    return path, lengths


def _take(stream: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``stream[..., idx[..., i], :]`` along axis -2 (idx broadcast over d)."""
    idx = idx[..., None].expand(*idx.shape, stream.shape[-1])
    return torch.gather(stream, -2, idx)


def _shift_to_end(stream: torch.Tensor, counts: torch.Tensor, *,
                  repeat_first: bool = False) -> torch.Tensor:
    """Move each path's valid block ``[0, counts)`` to the end of axis -2.

    Freed leading slots become zeros (increments) or copies of the first
    entry (points, ``repeat_first=True``).
    """
    n = stream.shape[-2]
    src = torch.arange(n, device=stream.device) - (n - counts)[..., None]
    out = _take(stream, src.clamp(0, n - 1))
    if repeat_first:
        return out
    return torch.where((src >= 0)[..., None], out, torch.zeros((), dtype=stream.dtype,
                                                               device=stream.device))


def _time_values(num: int, t0, t1, lengths: Optional[torch.Tensor],
                 dtype=_GRID_DTYPE, device=None) -> torch.Tensor:
    """Time grid over [t0, t1] in ``dtype``: (num,) or (..., num) ragged,
    t_i = t0 + (t1−t0)·i/(m−1) with i clamped to the true last index m−1."""
    idx = torch.arange(num, dtype=dtype, device=device)
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    t1 = torch.as_tensor(t1, dtype=dtype, device=device)
    if lengths is None:
        r = idx / torch.as_tensor(max(num - 1, 1), dtype=dtype, device=device)
    else:
        last = (lengths - 1).to(dtype)[..., None]
        r = torch.minimum(idx, last) / last
    return t0 + (t1 - t0) * r


def _grid_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least f32; f64 paths keep f64."""
    if not dtype.is_floating_point:
        return _GRID_DTYPE
    return torch.promote_types(dtype, _GRID_DTYPE)


def _grid_out_dtype(dtype: torch.dtype) -> torch.dtype:
    """Float paths keep their dtype; integer paths promote to f32."""
    return dtype if dtype.is_floating_point else _GRID_DTYPE


# ---------------------------------------------------------------------------
# materialised transforms
# ---------------------------------------------------------------------------

def time_augment(path: torch.Tensor, t0: float = 0.0, t1: float = 1.0,
                 lengths=None) -> torch.Tensor:
    """(x_{t_i}, t_i) ∈ R^{d+1} with a uniform time grid (per-path with
    ``lengths=``, reaching t1 at the true last point)."""
    L = path.shape[-2]
    if lengths is not None:
        lengths = _check_lengths(lengths, path.shape[:-2], L, path.device)
    dtype = _grid_out_dtype(path.dtype)
    t = _time_values(L, t0, t1, lengths, _grid_compute_dtype(path.dtype), path.device)
    t = torch.broadcast_to(t, path.shape[:-1]).to(dtype)[..., None]
    return torch.cat([path.to(dtype), t], dim=-1)


def lead_lag(path: torch.Tensor) -> torch.Tensor:
    """(X^Lead, X^Lag) ∈ R^{2d}, length 2L-1."""
    rep = torch.repeat_interleave(path, 2, dim=-2)
    return torch.cat([rep[..., 1:, :], rep[..., :-1, :]], dim=-1)


def basepoint(path: torch.Tensor) -> torch.Tensor:
    """Prepend the origin."""
    return torch.cat([torch.zeros_like(path[..., :1, :]), path], dim=-2)


def transform_increments(z: torch.Tensor, time_aug: bool, lead_lag_: bool,
                         t0: float = 0.0, t1: float = 1.0, *,
                         basepoint_: bool = False,
                         first: Optional[torch.Tensor] = None,
                         valid_steps=None) -> torch.Tensor:
    """On-the-fly transform of an increment stream z (..., L-1, d).

    ``basepoint_`` prepends the increment 0 → x_0 and needs ``first``, the
    (..., d) first point.  ``valid_steps`` (ragged batches) is the per-path
    count of valid increments after the transforms: the time channel is
    ``(t1−t0)/valid_steps`` on those rows and 0 on the padding.
    """
    if basepoint_:
        if first is None:
            raise ValueError(
                "transform_increments(basepoint_=True) needs first= (the "
                "(..., d) first path point): the 0 -> x_0 increment is not "
                "derivable from the increment stream")
        z = torch.cat([first[..., None, :], z], dim=-2)
    n = z.shape[-2]
    if lead_lag_:
        zeros = torch.zeros_like(z)
        lead_inc = torch.cat([z, zeros], dim=-1)
        lag_inc = torch.cat([zeros, z], dim=-1)
        z = torch.stack([lead_inc, lag_inc], dim=-2).reshape(
            *z.shape[:-2], 2 * n, 2 * z.shape[-1])
    if time_aug:
        steps = z.shape[-2]
        dtype = _grid_out_dtype(z.dtype)
        compute = _grid_compute_dtype(z.dtype)
        span = (torch.as_tensor(t1, dtype=compute, device=z.device)
                - torch.as_tensor(t0, dtype=compute, device=z.device))
        if valid_steps is None:
            dt = torch.broadcast_to(span / torch.as_tensor(steps, dtype=compute),
                                    (*z.shape[:-1], 1))
        else:
            per_path = span / valid_steps.to(compute)
            on = torch.arange(steps, device=z.device) < valid_steps[..., None]
            dt = torch.where(on, per_path[..., None],
                             torch.zeros((), dtype=compute, device=z.device))[..., None]
            dt = torch.broadcast_to(dt, (*z.shape[:-1], 1))
        z = torch.cat([z.to(dtype), dt.to(dtype)], dim=-1)
    return z


def transform_path(path: torch.Tensor, pipeline, lengths=None, *,
                   align: str = "start") -> torch.Tensor:
    """Materialise a :class:`TransformPipeline` on a path of points.

    With ``lengths=``, padded indices are clamped to each path's last true
    point; ``align="end"`` then moves the valid block to the end with
    leading first-point copies.
    """
    if align not in ("start", "end"):
        raise ValueError(f"align must be 'start' or 'end', got {align!r}")
    counts = None
    if lengths is not None:
        lengths = _check_lengths(lengths, path.shape[:-2], path.shape[-2], path.device)
        idx = torch.minimum(torch.arange(path.shape[-2], device=path.device),
                            lengths[..., None] - 1)
        path = _take(path, idx)
        counts = lengths
    if pipeline.basepoint:
        path = basepoint(path)
        if counts is not None:
            counts = counts + 1
    if pipeline.lead_lag:
        path = lead_lag(path)
        if counts is not None:
            counts = 2 * counts - 1
    if pipeline.time_aug:
        path = time_augment(path, pipeline.t0, pipeline.t1, lengths=counts)
    if counts is not None and align == "end":
        path = _shift_to_end(path, counts, repeat_first=True)
    return path


def pipeline_increments(path: torch.Tensor, pipeline, lengths=None, *,
                        align: str = "start") -> torch.Tensor:
    """Increments of ``transform_path(path, pipeline)``, computed from the
    raw increments.  With ``lengths=``, increments at or past each path's
    true end are zeroed and the time channel uses the per-path grid;
    ``align`` puts the zeros after ("start") or before ("end") the valid
    increments.
    """
    if align not in ("start", "end"):
        raise ValueError(f"align must be 'start' or 'end', got {align!r}")
    z = path[..., 1:, :] - path[..., :-1, :]
    first = path[..., 0, :] if pipeline.basepoint else None
    if lengths is None:
        return transform_increments(
            z, pipeline.time_aug, pipeline.lead_lag, pipeline.t0, pipeline.t1,
            basepoint_=pipeline.basepoint, first=first)
    lengths = _check_lengths(lengths, path.shape[:-2], path.shape[-2], path.device)
    valid = torch.arange(z.shape[-2], device=z.device) < (lengths[..., None] - 1)
    z = torch.where(valid[..., None], z, torch.zeros((), dtype=z.dtype, device=z.device))
    steps = pipeline.transformed_steps(lengths)
    z = transform_increments(
        z, pipeline.time_aug, pipeline.lead_lag, pipeline.t0, pipeline.t1,
        basepoint_=pipeline.basepoint, first=first, valid_steps=steps)
    if align == "end":
        z = _shift_to_end(z, steps)
    return z
