"""The Goursat layer's share of its roofline: the least time its work could
take at the card's published peaks (the entry's counts: the forward sweep,
and the adjoint sweep where the call has a gradient; increments read once,
values and gradients written once), over its device time a call
(``goursat_ms``), in %.  The work is compute-bound at every shape the cells
use."""

from sigbench.spec import HERE, load_json, load_reader


def read(run, data=None):
    if run.peaks is None:
        return None
    ops = load_json(HERE / "metrics" / "goursat_ms.json")
    s = load_reader("goursat_ms").device_s(run, ops)
    if not s:
        return None
    least = max(run.counts["goursat_flops"] / run.peaks["flops"],
                run.counts["goursat_bytes"] / run.peaks["bytes_per_s"])
    return 100.0 * least / s
