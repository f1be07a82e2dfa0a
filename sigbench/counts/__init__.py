"""The benchmark's yardstick: the work of each timed call (:mod:`.pde`) and
the published peaks of each card (``peaks.json``, by the name that
``torch.cuda.get_device_name()`` gives)."""

from __future__ import annotations

from typing import Optional

from ..spec import HERE, load_json


def peaks(device_kind: str) -> Optional[dict]:
    """``{"flops", "bytes_per_s"}`` of the card ``device_kind``, or None for
    a card the table does not hold (its metrics then read nothing)."""
    return load_json(HERE / "counts" / "peaks.json").get(device_kind)
