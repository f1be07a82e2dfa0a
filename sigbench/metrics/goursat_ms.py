"""Device time a call of the device operations launched under the Goursat
ops (``goursat_ms.json``: the port's ``repro_torch::goursat_*``), from the
trace, in ms."""


def device_s(run, data):
    """Seconds a call under the ops ``data["ops"]``, or None."""
    calls = run.traced_calls
    if run.trace is None or not calls:
        return None
    under = run.trace.under(data["ops"])
    if not under:
        return None
    return sum(k.dur_ns for k in under) * 1e-9 / len(calls)


def read(run, data):
    s = device_s(run, data)
    return None if s is None else s * 1e3
