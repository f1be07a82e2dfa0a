"""Truncated signatures by Horner's scheme: the Hopper kernel
(``kernel.py``, ``csrc/signature.cu``), its wrapper (``ops.py``) and the
direct-algorithm oracle (``ref.py``)."""

from .ops import (geometry, logsignature_from_increments,
                  signature_from_increments)

__all__ = ["geometry", "logsignature_from_increments",
           "signature_from_increments"]
