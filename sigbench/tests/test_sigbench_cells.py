"""Each cell runs at a tiny size on the CPU through the port's plain
backends and comes out correct."""

import math

import pytest

from sigbench import harness
from sigbench.tests import tiny


def _assert_line(out, cell):
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert [k for k in out if not k.startswith("_")][-1] == "check"
    for name, entry in out["check"].items():
        assert math.isfinite(entry["value"]) and entry["limit"] > 0
    # no peak memory on the CPU; a percentile wants two calls or more
    wanted = {m.name for m in tiny.cell(cell).end_to_end} - {"peak_mem_gib"}
    if out["attempted"] < 2:
        wanted.discard("call_ms_p95")
    assert set(out["metrics"]) == wanted


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_runs_and_is_correct(name):
    out = tiny.run(name)
    _assert_line(out, name)
    assert out["correct"] is True, out["_lines"]


def test_traced_run_reads_host_dispatch():
    out = tiny.run("pairs.sigkernel-train", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["host_dispatch_ms"]["value"] > 0
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_traced_run_traces_the_second_half(monkeypatch):
    """The profiler starts once half the window has passed: the host's
    metric reads the calls before it, the device's the calls inside it."""
    seen = {}
    real = harness.Run

    def record(**kw):
        run = real(**kw)
        seen["run"] = run
        return run

    monkeypatch.setattr(harness, "Run", record)
    out = tiny.run("gram.mmd2-test", trace=True, seconds=0.4)
    run = seen["run"]
    assert out["correct"] is True
    assert run.untraced_calls and run.traced_calls
    assert len(run.untraced_calls) + len(run.traced_calls) == len(run.calls)
    first = run.traced_calls[0][0] - run.calls[0][0]
    assert first >= 0.2 and out["device"]["window_s"] < 0.4 + 0.1
