"""Device time a call of the device operations launched under the port's
Δ span (``delta_ms.json``: ``repro_torch.delta``): the Δ built outside the
Goursat kernels and the float64 Δ that the fused backwards rebuild, with
its casts; from the trace, in ms.  The span never encloses a Goursat op, so
this time is not in ``goursat_ms``."""


def device_ms(run, spans):
    """Milliseconds a call of the device operations under a host span named
    in ``spans``, or None where there are none."""
    calls = run.traced_calls
    if run.trace is None or not calls:
        return None
    under = run.trace.under(spans)
    if not under:
        return None
    return sum(k.dur_ns for k in under) * 1e-6 / len(calls)


def read(run, data):
    return device_ms(run, data["spans"])
