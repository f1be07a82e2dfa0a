"""What the per-layer metrics read from a ``torch.profiler`` trace of the
window: every device operation with its start, its length and the chain of
host operations that launched it, the window's span, and the device's busy
time.

The harness marks the window and, inside it, each call, its
synchronisation and what it notes between calls with ``record_function`` spans
(``sigbench.*``).  A device operation's launching host operation is the
one the profiler links it to (its correlation id); that operation's
ancestors are the host operations that enclose it on the same thread.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

WINDOW = "sigbench.window"
#: the harness's spans inside a call, which name what the host was doing
SPANS = ("sigbench.call", "sigbench.sync", "sigbench.between")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    ops: tuple          # the launching host operation and its ancestors


@dataclasses.dataclass
class Trace:
    device_ops: list    # [DeviceOp] inside the window
    window_ns: int
    busy_ns: int
    idle_gaps: list     # [[what the host was doing, seconds]], longest first

    def under(self, names) -> list:
        """The device operations launched inside a host operation named in
        ``names``."""
        names = set(names)
        return [k for k in self.device_ops if names.intersection(k.ops)]

    def named(self, prefixes) -> list:
        """The device operations whose name starts with one of ``prefixes``."""
        prefixes = tuple(prefixes)
        return [k for k in self.device_ops if k.name.startswith(prefixes)]

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the ``n`` device operations that took most
        time (summed by name, up to the first ``(`` or ``<``)."""
        tot = defaultdict(int)
        for k in self.device_ops:
            tot[_short(k.name)] += k.dur_ns
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in best]


def _annotation(e) -> bool:
    """A host span mirrored on the device's timeline, not device work."""
    marked = getattr(e, "is_user_annotation", None)
    return bool(marked and marked()) or e.name().startswith("sigbench.")


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for sep in ("(", "<"):
        name = name.split(sep, 1)[0]
    return name.strip()[:120]


def _ancestry(cpu: list) -> list:
    """For each host event (start, end, thread, name), the names of its
    enclosing events on its thread, innermost first."""
    parent = [-1] * len(cpu)
    by_thread = defaultdict(list)
    for i, e in enumerate(cpu):
        by_thread[e[2]].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (cpu[i][0], -cpu[i][1]))
        stack = []
        for i in idx:
            while stack and cpu[stack[-1]][1] < cpu[i][1]:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
    chains = []
    for i in range(len(cpu)):
        names, j = [], i
        while j >= 0:
            names.append(cpu[j][3])
            j = parent[j]
        chains.append(tuple(names))
    return chains


def _label(t: int, cpu: list, starts: list, spans: list, span_starts: list) -> str:
    """What the host was doing at time ``t``: the harness's span around it
    and the innermost host operation under way (looked for among the 4,000
    host events that started last before ``t``)."""
    span = "outside a call"
    i = bisect.bisect_right(span_starts, t) - 1
    if i >= 0 and spans[i][1] >= t:
        span = spans[i][2]
    best = None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4000), -1):
        s, e, _, name, _ = cpu[j]
        if e >= t and name not in SPANS and name != WINDOW:
            best = name
            break
    return span if best is None else f"{span}: {best}"


def summarize(prof, device_index: int, longest: int = 1000) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose run
    wrapped its window in a ``sigbench.window`` span, for the card
    ``device_index``."""
    from torch.autograd import DeviceType
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            cpu.append((e.start_ns(), e.end_ns(), e.start_thread_id(), e.name(),
                        e.correlation_id()))
        elif e.device_index() == device_index and not _annotation(e):
            dev.append(e)
    cpu.sort(key=lambda c: (c[0], -c[1]))
    chains = _ancestry(cpu)
    by_corr = {c[4]: chains[i] for i, c in enumerate(cpu) if c[4]}
    spans = [c for c in cpu if c[3] == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = spans[0][0], spans[0][1]
    ops = []
    for e in dev:
        s = e.start_ns()
        if w0 <= s < w1:
            ops.append(DeviceOp(e.name(), s, e.duration_ns(),
                                by_corr.get(e.linked_correlation_id(), ())))
    ops.sort(key=lambda k: k.start_ns)
    busy, gaps, cursor = 0, [], w0
    for k in ops:
        end = min(k.start_ns + k.dur_ns, w1)
        if k.start_ns > cursor:
            gaps.append((k.start_ns - cursor, cursor))
        if end > cursor:
            busy += end - max(cursor, k.start_ns)
            cursor = end
    if w1 > cursor:
        gaps.append((w1 - cursor, cursor))
    gaps.sort(reverse=True)
    starts = [c[0] for c in cpu]
    spans = [(c[0], c[1], c[3]) for c in cpu if c[3] in SPANS]
    span_starts = [sp[0] for sp in spans]
    by_label = defaultdict(int)
    for length, at in gaps[:longest]:
        by_label[_label(at + length // 2, cpu, starts, spans, span_starts)] += length
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return Trace(device_ops=ops, window_ns=w1 - w0, busy_ns=busy,
                 idle_gaps=[[name, ns * 1e-9] for name, ns in idle])
