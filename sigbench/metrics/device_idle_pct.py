"""The share of the traced window in which rank 0's card ran no device
operation, in %."""


def read(run, data=None):
    if run.trace is None or not run.trace.device_ops or not run.trace.window_ns:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns / run.trace.window_ns)
