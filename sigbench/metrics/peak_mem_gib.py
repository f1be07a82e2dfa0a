"""``torch.cuda.max_memory_allocated()`` over the window (rank 0's card), GiB."""


def read(run, data=None):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
