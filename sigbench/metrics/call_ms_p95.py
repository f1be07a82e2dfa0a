"""The 95th percentile of the latency of every call in the window, from its
start on the host clock to the end of its synchronisation, in ms."""

import statistics


def read(run, data=None):
    if len(run.calls) < 2:
        return None
    lat = [(end - start) * 1e3 for start, _, end in run.calls]
    return statistics.quantiles(lat, n=100)[94]
