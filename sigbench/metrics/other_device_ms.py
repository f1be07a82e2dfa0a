"""Device time a call outside the Goursat ops and the collectives: Δ and
its pullback, the float64 Δ the backwards rebuild, the loss's assembly,
copies and fills; from the trace, in ms."""

from sigbench.spec import HERE, load_json


def read(run, data=None):
    calls = run.traced_calls
    if run.trace is None or not calls or not run.trace.device_ops:
        return None
    goursat = set(load_json(HERE / "metrics" / "goursat_ms.json")["ops"])
    nccl = tuple(load_json(HERE / "metrics" / "collective_ms.json")["kernels"])
    rest = [k for k in run.trace.device_ops
            if not goursat.intersection(k.ops) and not k.name.startswith(nccl)]
    return sum(k.dur_ns for k in rest) * 1e-6 / len(calls)
