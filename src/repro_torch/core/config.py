"""Kernel configuration as frozen dataclasses.

Counterpart of ``repro/core/config.py``.  The JAX package registers these
as pytrees; here they are plain frozen dataclasses:

``TransformPipeline(time_aug, lead_lag, basepoint, t0, t1)``
    The §4 path transforms, applied in the order basepoint → lead-lag →
    time-aug.
``GridConfig(lam1, lam2, scheme, interior_dtype)``
    Dyadic refinement of the Goursat grid, the cell-update stencil and the
    interior precision.
``LaunchConfig(pde_strip, sig_bt, sig_lb, gram_row_block, band_chunk)``
    Launch parameters: the strip height cap of the Goursat kernels, the
    threads and length block of the Horner kernel, the Gram row block, the
    anti-diagonal solver's batch chunk.  They never change the mathematics.
``Linear(scale)`` / ``RBF(sigma)``
    The static-kernel lift.  ``Linear`` builds Δ from increments with one
    matmul (and is what the fused kernels take); ``RBF`` goes through the
    Δ-from-Gram double increment (:func:`delta_from_gram`).

The JAX package's deprecated keyword arguments (``lam1=``, ``time_aug=``,
``use_pallas=``, ...) are not ported.  :func:`configs_from_reference`
builds these objects from the field values of the JAX package's configs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.sigkernel_pde.stencil import (INTERIOR_DTYPES, SCHEMES,
                                                      delta_einsum)


@dataclasses.dataclass(frozen=True)
class TransformPipeline:
    """§4 transforms, in order basepoint → lead-lag → time-aug.

    Attributes:
      time_aug: append a uniform time channel over ``[t0, t1]``.
      lead_lag: interleave lead/lag copies (2d channels, 2L-1 points).
      basepoint: prepend the origin, making translations visible to S(x).
      t0 / t1: endpoints of the time grid (only used with ``time_aug``).
    """

    time_aug: bool = False
    lead_lag: bool = False
    basepoint: bool = False
    t0: float = 0.0
    t1: float = 1.0

    def transformed_dim(self, d: int) -> int:
        """Channel count after the pipeline."""
        if self.lead_lag:
            d = 2 * d
        if self.time_aug:
            d = d + 1
        return d

    def transformed_steps(self, L):
        """Increment count after the pipeline for an L-point path (``L`` an
        int or an integer tensor of per-path lengths)."""
        n = L - 1
        if self.basepoint:
            n = n + 1
        if self.lead_lag:
            n = n * 2
        return n


#: Goursat cell-update stencils
GRID_SCHEMES = SCHEMES

#: interior-cell storage precisions
GRID_INTERIOR_DTYPES = INTERIOR_DTYPES


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Goursat discretisation: refinement (λ1, λ2), stencil, interior dtype.

    A refined grid has ``(Lx << lam1) · (Ly << lam2)`` cells.  ``scheme``
    is ``"order1"`` (default) or ``"order2"``; ``interior_dtype`` is
    ``"float32"`` (default) or ``"bfloat16"`` (interior cells rounded
    through bf16 after each update; boundary and readout stay f32).
    """

    lam1: int = 0
    lam2: int = 0
    scheme: str = "order1"
    interior_dtype: str = "float32"

    def __post_init__(self):
        for name in ("lam1", "lam2"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(
                    f"GridConfig.{name} must be a non-negative Python int "
                    f"(it sets static grid shapes), got {v!r}")
        if self.scheme not in GRID_SCHEMES:
            raise ValueError(
                f"GridConfig.scheme must be one of {GRID_SCHEMES} (the "
                f"Goursat cell-update stencil, a static compile-time "
                f"choice), got {self.scheme!r}")
        if self.interior_dtype not in GRID_INTERIOR_DTYPES:
            raise ValueError(
                f"GridConfig.interior_dtype must be one of "
                f"{GRID_INTERIOR_DTYPES} (interior-cell storage precision; "
                f"boundary/readout always stay float32), "
                f"got {self.interior_dtype!r}")


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """Launch parameters; every field defaults to ``None`` (library default).

    Attributes:
      pde_strip: cap on the Goursat kernels' strip height T (the fused
        kernels' wavefront threads, the checkpoint rows' strip that the
        backward sweeps) and on the rows the precomputed-Δ forward's warps
        cover at once (at least 32); a power of two.  Default:
        :func:`repro_torch.kernels.sigkernel_pde.ops.choose_T` and
        :func:`~repro_torch.kernels.sigkernel_pde.ops.geometry` pick from
        the shape.
      sig_bt: cap on the threads per block of the Horner kernel; a power of
        two.  The TPU kernel's batch tile (paths on the lanes of one
        program) has no counterpart on the card, where one block runs one
        slice of one path (its entries with a given prefix of first
        indices); a lower cap cuts the signature into more, smaller slices.
        Default: :func:`repro_torch.kernels.signature.ops.geometry`.
      sig_lb: cap on the Horner kernel's length block, the increments one
        block stages in shared memory at a time (the TPU kernel's length
        block); a power of two.  Default: the most that fit 48 KB, up to 32
        (:func:`repro_torch.kernels.signature.ops.geometry`).
      gram_row_block: Gram rows in flight at once when the caller passes no
        ``row_block=``.
      band_chunk: at most this many Goursat problems per anti-diagonal
        sweep (the CPU solver).
    """

    pde_strip: Optional[int] = None
    sig_bt: Optional[int] = None
    sig_lb: Optional[int] = None
    gram_row_block: Optional[int] = None
    band_chunk: Optional[int] = None

    _POW2_FIELDS = ("pde_strip", "sig_bt", "sig_lb")

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"LaunchConfig.{f.name} must be None or a positive "
                    f"Python int (it sets static kernel block shapes), "
                    f"got {v!r}")
            if f.name in self._POW2_FIELDS and v & (v - 1):
                raise ValueError(
                    f"LaunchConfig.{f.name} must be a power of two "
                    f"(kernel tiling constraint), got {v}")


def resolve_launch(launch: Optional[LaunchConfig]) -> LaunchConfig:
    """Default and type-check the ``launch=`` argument."""
    if launch is None:
        return LaunchConfig()
    if not isinstance(launch, LaunchConfig):
        raise TypeError(f"launch= expects a LaunchConfig, got {type(launch).__name__}")
    return launch


# ---------------------------------------------------------------------------
# static-kernel lifts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StaticKernel:
    """Base class of the static-kernel lifts κ under the signature kernel.

    ``Linear`` builds Δ from increments (``delta_from_increments``); every
    other lift implements ``gram(x, y)``, the pointwise κ(x_i, y_j) of two
    point streams (leading dims broadcast), whose double increment is Δ.
    """

    #: Δ is a plain increment matmul (what the fused kernels take)
    lifts_increments = False


@dataclasses.dataclass(frozen=True)
class Linear(StaticKernel):
    """κ(x, y) = scale · ⟨x, y⟩ — the paper's signature kernel."""

    scale: float = 1.0
    lifts_increments = True

    def delta_from_increments(self, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
        """Δ[i,j] = scale · ⟨dx_i, dy_j⟩ — one batched matmul, accumulated in
        float64 so that it equals the Δ the fused kernels build."""
        return _maybe_scale(delta_einsum("...id,...jd->...ij", dx, dy), self.scale)


@dataclasses.dataclass(frozen=True)
class RBF(StaticKernel):
    """κ(x, y) = exp(−‖x−y‖² / (2σ²)) — the Gaussian lift."""

    sigma: float = 1.0

    def gram(self, x, y):
        sq = ((x * x).sum(-1)[..., :, None] + (y * y).sum(-1)[..., None, :]
              - 2.0 * torch.einsum("...id,...jd->...ij", x, y))
        sq = sq.clamp_min(0.0)           # clamp catastrophic cancellation
        return torch.exp(-sq / (2.0 * torch.as_tensor(self.sigma, dtype=sq.dtype,
                                                      device=sq.device) ** 2))


def _maybe_scale(v: torch.Tensor, scale) -> torch.Tensor:
    """Multiply by ``scale`` unless it is the Python number 1."""
    if isinstance(scale, (int, float)) and scale == 1.0:
        return v
    return v * scale


def delta_from_gram(G: torch.Tensor) -> torch.Tensor:
    """Δ[i,j] = G[i+1,j+1] − G[i+1,j] − G[i,j+1] + G[i,j]:
    (..., Lx, Ly) -> (..., Lx-1, Ly-1)."""
    return (G[..., 1:, 1:] - G[..., 1:, :-1]
            - G[..., :-1, 1:] + G[..., :-1, :-1])


def resolve_kernel_configs(transforms, grid, static_kernel):
    """Default and type-check the three configuration arguments."""
    if transforms is None:
        transforms = TransformPipeline()
    elif not isinstance(transforms, TransformPipeline):
        raise TypeError(f"transforms= expects a TransformPipeline, got "
                        f"{type(transforms).__name__}")
    if grid is None:
        grid = GridConfig()
    elif not isinstance(grid, GridConfig):
        raise TypeError(f"grid= expects a GridConfig, got {type(grid).__name__}")
    if static_kernel is None:
        static_kernel = Linear()
    elif not isinstance(static_kernel, StaticKernel):
        raise TypeError(f"static_kernel= expects a StaticKernel (Linear / RBF), "
                        f"got {type(static_kernel).__name__}")
    return transforms, grid, static_kernel


# ---------------------------------------------------------------------------
# configurations carried across from the JAX package
# ---------------------------------------------------------------------------

_LIFTS = {"Linear": Linear, "RBF": RBF}


def _plain(v):
    """A 0-d numpy array or tensor becomes a Python scalar; others pass."""
    if isinstance(v, (np.ndarray, np.generic, torch.Tensor)) and np.ndim(v) == 0:
        return v.item()
    return v


def configs_from_reference(fields: dict) -> dict:
    """The port's configs from the field values of the JAX package's.

    This system has no weights: its parameters are its configs, whose
    ``RBF.sigma``, ``Linear.scale`` and ``TransformPipeline.t0``/``t1``
    are array leaves in the JAX package.  ``fields`` holds plain dicts of
    field values, as ``dataclasses.asdict`` gives them (numpy arrays or
    Python scalars), under any of the keys

    * ``"transforms"`` — :class:`TransformPipeline` fields;
    * ``"grid"`` — :class:`GridConfig` fields;
    * ``"launch"`` — :class:`LaunchConfig` fields (knobs the port does not
      have are dropped);
    * ``"static_kernel"`` — the lift's fields plus ``"kind"``: ``"Linear"``
      or ``"RBF"``.

    Returns ``{"transforms", "grid", "static_kernel", "launch"}`` with the
    defaults for keys that were not given.
    """
    unknown = set(fields) - {"transforms", "grid", "launch", "static_kernel"}
    if unknown:
        raise ValueError(f"unknown config keys {sorted(unknown)}")

    def build(cls, values, keep=None):
        values = {k: _plain(v) for k, v in (values or {}).items()
                  if keep is None or k in keep}
        return cls(**values)

    lift = dict(fields.get("static_kernel") or {"kind": "Linear"})
    kind = lift.pop("kind", None)
    if kind not in _LIFTS:
        raise ValueError(f"static_kernel 'kind' must be one of {sorted(_LIFTS)}, "
                         f"got {kind!r}")
    launch_fields = {f.name for f in dataclasses.fields(LaunchConfig)}
    return {
        "transforms": build(TransformPipeline, fields.get("transforms")),
        "grid": build(GridConfig, fields.get("grid")),
        "static_kernel": build(_LIFTS[kind], lift),
        "launch": build(LaunchConfig, fields.get("launch"), keep=launch_fields),
    }
