"""Device time a call of the collectives' kernels (names starting with a
prefix in ``collective_ms.json``: NCCL's) on rank 0, from the trace, in ms."""


def device_s(run, data):
    calls = run.traced_calls
    if run.trace is None or not calls:
        return None
    found = run.trace.named(data["kernels"])
    if not found:
        return None
    return sum(k.dur_ns for k in found) * 1e-9 / len(calls)


def read(run, data):
    s = device_s(run, data)
    return None if s is None else s * 1e3
