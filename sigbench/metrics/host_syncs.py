"""The transfers a call that block the host on the card: the device
operations (the copies) launched under the port's sync span
(``host_syncs.json`` ``spans``: ``repro_torch.sync``), over the traced
calls.  0.0 where the program marks its calls (device operations under one
of its entry spans, ``entries``) and no copy lies under the sync span; None
where the trace holds none of the program's spans."""


def read(run, data):
    calls = run.traced_calls
    if run.trace is None or not calls or not run.trace.under(data["entries"]):
        return None
    return len(run.trace.under(data["spans"])) / len(calls)
