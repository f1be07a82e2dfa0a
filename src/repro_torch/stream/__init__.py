"""Streaming signature engine: growing paths with O(1) interval queries.

Counterpart of ``repro.stream``: :class:`Path` (per-prefix signature store:
every interval query one Chen combine, every append an O(chunk) extension)
and the coalesced update that :mod:`repro_torch.serve` batches concurrent
streams through.
"""

from .path import (Path, RollingConfig, coalesced_update, reset_trace_counts,
                   trace_counts)

__all__ = ["Path", "RollingConfig", "coalesced_update", "reset_trace_counts",
           "trace_counts"]
