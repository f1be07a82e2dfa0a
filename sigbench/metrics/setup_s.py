"""Seconds from the process's start to the first timed call: imports, the
kernel libraries' load (and, in a fresh checkout, their build), the inputs
and the warm-up calls."""


def read(run, data=None):
    return run.setup_s
