"""Device time a call of the device operations launched under the port's
pullback span (``pullback_ms.json``: ``repro_torch.pullback``): the fused
backwards' products, float64 sums and casts that carry ∂F/∂Δ back to the
increments; from the trace, in ms.  Disjoint from ``goursat_ms`` and
``delta_ms``."""

from sigbench.spec import load_reader


def read(run, data):
    return load_reader("delta_ms").device_ms(run, data["spans"])
