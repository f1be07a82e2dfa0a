"""A signature-feature server for concurrently growing streams.

Counterpart of ``repro/serve/sig_server.py``.  :class:`SigFeatureServer`
keeps one :class:`repro_torch.stream.Path` per named stream:

* **appends are admitted, not applied** — ``append(name, points)`` queues
  the chunk; ``flush()`` applies every pending append, grouping streams by
  ``(capacity, chunk bucket)`` into one
  :func:`repro_torch.stream.coalesced_update` a group (padded to a
  power-of-two group size with no-op members); streams whose buffers must
  grow are updated alone;
* **queries are O(1)** — ``signature`` / ``logsignature`` / ``rolling``
  are Chen combines against the stream's prefix store, never re-scans;
* **features** — ``features(name, window)`` runs the server's
  :class:`repro_torch.core.features.FeatureConfig` (``method="rff"``) over
  the stream's last ``window`` raw points, as the offline ``features=``
  path of the Gram entry points does.

The server lives on one device: ``device=None`` means ``"cuda"`` and raises
without CUDA, as the ``nn.Module`` entry points do; ``device="cpu"`` runs
the plain versions.  ``stats()`` reports the admission counters and the
stream module's call counters.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from ..api import card_device
from ..core import transforms as tf
from ..core.config import Linear, TransformPipeline
from ..core.features import FeatureConfig, resolve_features, rff_features
from ..stream import path as stream_path
from ..stream.path import Path, coalesced_update


class SigFeatureServer:
    """Serve signature features over named, concurrently growing streams.

    Args:
      depth: signature truncation depth shared by every stream.
      transforms: optional :class:`TransformPipeline` (lead-lag only, the
        streaming restriction of :class:`Path`).
      features: optional :class:`FeatureConfig` enabling :meth:`features`.
        Only ``method="rff"`` can be served online: Nyström landmarks are
        fitted against an offline reference batch.
      static_kernel: static kernel of the feature lift (default ``Linear()``).
      device: where the streams live; ``None`` means ``"cuda"``.
    """

    def __init__(self, depth: int, *, transforms: Optional[TransformPipeline] = None,
                 features: Optional[FeatureConfig] = None, static_kernel=None,
                 device=None):
        self.device = card_device(device, type(self).__name__)
        self.depth = depth
        self.transforms = transforms if transforms is not None else TransformPipeline()
        feats = resolve_features(features)
        if feats is not None and feats.method != "rff":
            raise ValueError(
                f"SigFeatureServer can only serve method='rff' features online "
                f"(got {feats.method!r}): Nystroem landmarks are fitted against "
                f"an offline reference batch — compute those features with "
                f"sigkernel_gram(features=...) instead")
        self.features_config = feats
        self.static_kernel = static_kernel if static_kernel is not None else Linear()
        self._streams: Dict[str, Path] = {}
        self._pending: Dict[str, List[torch.Tensor]] = {}
        self._stats = {
            "streams": 0, "points_appended": 0, "flushes": 0, "update_groups": 0,
            "solo_updates": 0, "coalesced_streams": 0, "queries": 0,
            "feature_requests": 0,
        }

    # -- stream lifecycle ----------------------------------------------------

    def open_stream(self, name: str, points) -> Path:
        """Open stream ``name`` with its initial (L, d) points, L ≥ 2."""
        if name in self._streams:
            raise ValueError(f"stream {name!r} already open")
        p = Path.from_points(torch.as_tensor(points, device=self.device), self.depth,
                             transforms=self.transforms)
        if p.points.dim() != 2:
            raise ValueError(f"streams are single paths: expected (L, d) initial "
                             f"points, got shape {tuple(p.points.shape)}")
        self._streams[name] = p
        self._stats["streams"] += 1
        return p

    def close_stream(self, name: str) -> None:
        self._require(name)
        self._streams.pop(name)
        self._pending.pop(name, None)
        self._stats["streams"] -= 1

    def path(self, name: str) -> Path:
        """The stream's current :class:`Path` (pending appends excluded)."""
        return self._require(name)

    def _require(self, name: str) -> Path:
        if name not in self._streams:
            raise KeyError(f"unknown stream {name!r}; open it with open_stream() "
                           f"(open: {sorted(self._streams)})")
        return self._streams[name]

    # -- admission batching --------------------------------------------------

    def append(self, name: str, points) -> None:
        """Queue new points for ``name`` ((k, d), or (d,) for one tick);
        applied at the next :meth:`flush`."""
        d = self._require(name).d
        pts = torch.as_tensor(points, device=self.device)
        if pts.dim() == 1:
            pts = pts[None, :]
        if pts.dim() != 2 or pts.shape[-1] != d:
            raise ValueError(f"append expects (k, {d}) points for stream {name!r}, "
                             f"got shape {tuple(pts.shape)}")
        self._pending.setdefault(name, []).append(pts)
        self._stats["points_appended"] += int(pts.shape[0])

    def flush(self) -> int:
        """Apply all pending appends; returns the number of streams updated.

        Streams are grouped by ``(capacity, chunk bucket)`` and each group
        is one batched :func:`coalesced_update`; streams whose buffers must
        grow first are updated alone (growth doubles the capacity, so it is
        rare)."""
        if not self._pending:
            return 0
        groups: Dict[Tuple[int, int], List[Tuple[str, torch.Tensor]]] = {}
        solo: List[Tuple[str, torch.Tensor]] = []
        for name, chunks in self._pending.items():
            chunk = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
            p = self._streams[name]
            kc = tf.bucket_length(chunk.shape[0], minimum=1)
            if len(p) + kc > p.capacity:
                solo.append((name, chunk))
            else:
                groups.setdefault((p.capacity, kc), []).append((name, chunk))
        n = 0
        for _, members in sorted(groups.items()):
            updated = coalesced_update([self._streams[name] for name, _ in members],
                                       [c for _, c in members])
            for (name, _), new_path in zip(members, updated):
                self._streams[name] = new_path
            n += len(members)
            self._stats["update_groups"] += 1
            self._stats["coalesced_streams"] += len(members)
        for name, chunk in solo:
            self._streams[name] = self._streams[name].update(chunk)
            n += 1
            self._stats["solo_updates"] += 1
        self._pending.clear()
        self._stats["flushes"] += 1
        return n

    # -- queries -------------------------------------------------------------

    def signature(self, name: str, i: int = 0, j: Optional[int] = None) -> torch.Tensor:
        """Signature of ``stream[i:j]`` — one Chen combine (see :class:`Path`)."""
        self._stats["queries"] += 1
        return self._require(name).signature(i, j)

    def logsignature(self, name: str, i: int = 0, j: Optional[int] = None, *,
                     mode: str = "lyndon") -> torch.Tensor:
        self._stats["queries"] += 1
        return self._require(name).logsignature(i, j, mode=mode)

    def rolling(self, name: str, window, *, stride: int = 1) -> torch.Tensor:
        self._stats["queries"] += 1
        return self._require(name).rolling(window, stride=stride)

    def features(self, name: str, window: Optional[int] = None) -> torch.Tensor:
        """RFF signature features of the stream's last ``window`` points
        (default: all of them), equal to the offline ``rff_features`` of
        those points under the server's transforms and static kernel."""
        if self.features_config is None:
            raise ValueError("this server has no FeatureConfig; pass features= to "
                             "SigFeatureServer to serve feature vectors")
        p = self._require(name)
        L = len(p)
        if window is None:
            window = L
        if not 2 <= window <= L:
            raise ValueError(f"features window must be in [2, {L}] for stream "
                             f"{name!r}, got {window}")
        self._stats["feature_requests"] += 1
        pts = p.points[L - window:L]
        return rff_features(pts[None], self.features_config, self.transforms,
                            self.static_kernel)[0]

    # -- warmup & stats ------------------------------------------------------

    def warmup(self, lengths=(8, 16), chunk_sizes=(1,), group_sizes=(1,)) -> float:
        """Run the build and update operations once at the given buckets.

        The JAX package traces its kernels here; the port has no trace
        cache, so warming pays the device's one-time costs (kernel loading,
        allocator growth) before the first real tick.  Returns the seconds
        spent."""
        t0 = time.perf_counter()
        d = next(iter(self._streams.values())).d if self._streams else 2
        for L in lengths:
            C = tf.bucket_length(L)
            for g in group_sizes:
                gb = tf.bucket_length(g, minimum=1)
                for k in chunk_sizes:
                    kc = tf.bucket_length(k, minimum=1)
                    if C < kc + 2:
                        continue
                    pts = torch.linspace(0.0, 1.0, C, device=self.device)[:, None]
                    batch = pts.expand(gb, C, d)
                    p = Path.from_points(batch, self.depth, transforms=self.transforms)
                    stream_path._update_kernel(
                        p.points, p.prefix, p.inv_prefix,
                        torch.full((gb,), C - kc, device=self.device), batch[:, :kc],
                        torch.full((gb,), k, device=self.device), depth=self.depth,
                        lead_lag=self.transforms.lead_lag)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def stats(self) -> dict:
        """Admission and query counters, plus the stream module's call
        counters (``trace_counts``)."""
        out = dict(self._stats)
        out["pending_streams"] = len(self._pending)
        out["trace_counts"] = stream_path.trace_counts()
        return out
