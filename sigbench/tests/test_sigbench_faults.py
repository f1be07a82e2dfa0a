"""A broken timed path, or the control in the program's place, comes out
not correct: each cell at a tiny size on the CPU, under each fault that its
file (``workloads/<cell>.json``) names."""

import pytest

from sigbench import spec
from sigbench.tests import tiny

CASES = [(name, fault) for name in tiny.CELLS for fault in spec.load_cell(name).workload["faults"]]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{f.rsplit(':', 1)[-1]}-{n}" for n, f in CASES])
def test_broken_path_is_not_correct(name, fault):
    out = tiny.run(name, fault=fault)
    assert out["correct"] is False, out["_lines"]
