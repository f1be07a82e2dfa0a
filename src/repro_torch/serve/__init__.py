"""Serving loops: the signature-feature server and the LM decode steps.

Counterpart of :mod:`repro.serve`: :mod:`repro_torch.serve.sig_server` is
the streaming-signature serving loop (admission-batched appends over
:class:`repro_torch.Path` streams); :mod:`repro_torch.serve.step` holds the
LM prefill / decode step builders that ``examples/serve_lm_torch.py`` uses.
"""

from .sig_server import SigFeatureServer

__all__ = ["SigFeatureServer"]
