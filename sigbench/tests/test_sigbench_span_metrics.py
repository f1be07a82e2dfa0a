"""The readers of the port's spans (``delta_ms``, ``pullback_ms``,
``host_syncs``) on a synthetic trace: their values a call, None where the
program marks nothing, and ``goursat_ms``, ``delta_ms`` and ``pullback_ms``
disjoint."""

import pytest

from repro_torch import spans
from sigbench import harness, spec
from sigbench.trace import DeviceOp, Trace

READERS = ("delta_ms", "pullback_ms", "host_syncs")
MS = 1_000_000


def _op(name, ms, *chain):
    return DeviceOp(name=name, start_ns=0, dur_ns=int(ms * MS), ops=tuple(chain))


def _run(ops, calls=2):
    busy = sum(k.dur_ns for k in ops)
    trace = Trace(device_ops=ops, window_ns=busy + MS, busy_ns=busy, idle_gaps=[])
    return harness.Run(calls=[(0.0, 0.001, 0.002)] * (calls + 3), setup_s=1.0,
                       peak_window_bytes=0, attempted=calls + 3, failed=0, counts={},
                       peaks=None, trace=trace, traced_from=3)


def _read(name, run):
    return spec._metric({"name": name, "unit": "", "better": "", "source": ""}).read(run)


#: one call's device work as the program marks it: the sync copies under
#: the entry, the rebuilt Δ and the pullback in the backward (on the
#: autograd thread, outside the entry), the Goursat ops beside them
CALL = [
    _op("Memcpy HtoD (Pageable -> Device)", 0.01, "aten::copy_", spans.SYNC, spans.ENTRY_GRAM,
        spans.ENTRY_MMD2, "sigbench.call"),
    _op("Memcpy HtoD (Pageable -> Device)", 0.01, "aten::copy_", spans.SYNC, spans.ENTRY_GRAM,
        spans.ENTRY_MMD2, "sigbench.call"),
    _op("goursat_fwd_fused", 4.0, "repro_torch::goursat_fwd_fused", spans.ENTRY_GRAM,
        spans.ENTRY_MMD2, "sigbench.call"),
    _op("elementwise_kernel", 1.5, "aten::_to_copy", spans.DELTA, "_GramFusedBackward"),
    _op("gemm_f64", 0.5, "aten::bmm", "aten::einsum", spans.DELTA, "_GramFusedBackward"),
    _op("goursat_bwd", 7.0, "repro_torch::goursat_bwd", "_GramFusedBackward"),
    _op("gemm_f32", 1.0, "aten::bmm", spans.PULLBACK, "_GramFusedBackward"),
    _op("reduce_kernel", 0.25, "aten::sum", spans.PULLBACK, "_GramFusedBackward"),
    _op("index_kernel", 0.2, "aten::index", spans.ENTRY_GRAM, spans.ENTRY_MMD2,
        "sigbench.call"),
]


def test_readers_read_a_call():
    run = _run(CALL * 2)
    assert _read("delta_ms", run) == pytest.approx(2.0)
    assert _read("pullback_ms", run) == pytest.approx(1.25)
    assert _read("host_syncs", run) == 2.0
    assert _read("goursat_ms", run) == pytest.approx(11.0)


def test_readers_are_disjoint_and_within_the_other_device_time():
    run = _run(CALL)
    goursat, delta, pull = (_read(m, run) for m in ("goursat_ms", "delta_ms", "pullback_ms"))
    total = sum(k.dur_ns for k in CALL) * 1e-6 / 2
    assert goursat + delta + pull <= total + 1e-12
    other = _read("other_device_ms", run)
    assert delta + pull <= other + 1e-12
    assert goursat + other == pytest.approx(total)


def test_no_sync_under_the_entries_reads_zero():
    """The program marks its calls but blocks on nothing: 0.0, not None
    (the pairs entry)."""
    ops = [k for k in CALL if spans.SYNC not in k.ops]
    assert _read("host_syncs", _run(ops)) == 0.0


def test_a_program_without_spans_reads_nothing():
    """The parent of the spans: device operations under the harness's spans
    and the Goursat ops only.  Every reader gives None (the line leaves the
    metric out); the Goursat layer still reads."""
    bare = [DeviceOp(k.name, k.start_ns, k.dur_ns,
                     tuple(n for n in k.ops if not n.startswith("repro_torch.")))
            for k in CALL]
    run = _run(bare)
    assert [_read(m, run) for m in READERS] == [None, None, None]
    assert _read("goursat_ms", run) == pytest.approx(5.5)


def test_no_trace_or_no_calls_reads_nothing():
    run = _run(CALL)
    untraced = harness.Run(calls=run.calls, setup_s=1.0, peak_window_bytes=0, attempted=5,
                           failed=0, counts={}, peaks=None)
    empty = _run(CALL, calls=0)
    for m in READERS:
        assert _read(m, untraced) is None and _read(m, empty) is None


def test_span_names_are_the_programs():
    """Every name the readers' data files list is one of the port's span
    constants, and none is a Goursat op that ``goursat_ms`` reads."""
    ops = set(spec.load_json(spec.HERE / "metrics" / "goursat_ms.json")["ops"])
    for m in READERS:
        data = spec.load_json(spec.HERE / "metrics" / f"{m}.json")
        names = [n for v in data.values() for n in v]
        assert names and set(names) <= set(spans.NAMES), m
        assert not ops.intersection(names)
