"""Calls completed in the window, over the window's seconds (host clock)."""


def read(run, data=None):
    return len(run.calls) / run.window_s if run.calls else None
