"""The whole call's share of the card's peak while the card works: the
operations a call needs (the entry's counts: the Goursat sweeps, Δ's
products and their pullback) times the traced calls, over the device's busy
time in the trace times the published peak, in %.  The idle time is
``device_idle_pct``'s; the busy time is the device's own, which the
profiler's cost on the host does not stretch."""


def read(run, data=None):
    calls = run.traced_calls
    if run.peaks is None or run.trace is None or not calls or not run.trace.busy_ns:
        return None
    busy = run.trace.busy_ns * 1e-9
    return 100.0 * run.counts["call_flops"] * len(calls) / (busy * run.peaks["flops"])
