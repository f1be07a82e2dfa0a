"""The host's share of a call: from its start until it returns, before the
synchronisation (host clock), the mean over the calls that ran without the
profiler (the first half of a traced run's window), in ms."""


def read(run, data=None):
    calls = run.untraced_calls
    if not calls:
        return None
    return sum(ret - start for start, ret, _ in calls) / len(calls) * 1e3
