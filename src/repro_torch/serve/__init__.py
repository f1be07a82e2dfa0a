"""Serving loops: the signature-feature server over growing streams.

Counterpart of :mod:`repro.serve.sig_server` (the LM decode steps of the
JAX package are not ported yet).
"""

from .sig_server import SigFeatureServer

__all__ = ["SigFeatureServer"]
