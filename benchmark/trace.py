"""Reduce a ``torch.profiler`` window to what the per-layer readers read.

From the profiler's events: every device operation (kernel, copy, fill)
with its interval, its name and the host operator that launched it; the
host's operators and the benchmark's own spans (``record_function``
ranges opened around calls into the program) with their intervals.
Device time is charged to the innermost host operator that launched it,
as ``tools/torch_diffusion_profile.op_device_ms`` charges it, and to the
spans in whose range that launch lies."""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

SPAN_PREFIX = "bench."
# the profiler's own bookkeeping, which shares a correlation id with the operator it interrupts
PROFILER_EVENTS = ("Activity Buffer Request", "Runtime Triggered Module Loading", "Lazy Function Loading")


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    op: str  # the host operator that launched it ("" if none was recorded)
    launch_ns: int  # when the host launched it (-1 if unknown)


@dataclass
class Trace:
    window_ns: tuple  # (start, end) of the traced window on the profiler's clock
    steps: int  # train steps inside the window
    device_ops: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)  # (start_ns, end_ns, name)
    spans: list = field(default_factory=list)  # (start_ns, end_ns, name) of the benchmark's spans

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the window."""
        lo, hi = self.window_ns
        out = []
        for s, e in sorted((max(o.start_ns, lo), min(o.end_ns, hi)) for o in self.device_ops):
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernels(self) -> list:
        """The kernels (copies and fills left out)."""
        return [o for o in self.device_ops if not o.name.startswith(("Memcpy", "Memset"))]

    def device_s_where(self, pred) -> float:
        return sum(o.end_ns - o.start_ns for o in self.device_ops if pred(o)) * 1e-9

    def in_span(self, name: str):
        """A predicate: the operation was launched inside a span ``name``."""
        ranges = sorted((s, e) for s, e, n in self.spans if n == name)
        starts = [s for s, _ in ranges]

        def pred(o: DeviceOp) -> bool:
            i = bisect.bisect_right(starts, o.launch_ns) - 1
            return i >= 0 and o.launch_ns <= ranges[i][1]
        return pred

    def top_device_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for o in self.device_ops:
            by[o.name[:160]] += (o.end_ns - o.start_ns) * 1e-9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time between the busy intervals, summed by what the
        host was doing when the device went idle: the innermost host
        operator or span running then (one sweep over the host's intervals
        in order of start, keeping those still open on a stack)."""
        busy = self.busy_intervals()
        lo, hi = self.window_ns
        edges = [(lo, busy[0][0] if busy else hi)] + [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        if busy:
            edges.append((busy[-1][1], hi))
        host = sorted(self.host_ops + self.spans, key=lambda h: (h[0], -h[1]))  # outer before inner
        by = collections.Counter()
        stack, i = [], 0
        for s, e in sorted(g for g in edges if g[1] > g[0]):
            while i < len(host) and host[i][0] <= s:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < s:
                stack.pop()
            by[(stack[-1][2] if stack else "(no host operator)")[:160]] += (e - s) * 1e-9
        return [[k, v] for k, v in by.most_common(n)]


def collect(prof, window_span: str, steps: int) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` whose window
    is the host interval of the span ``window_span``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ops_by_corr, launch_by_corr = {}, {}
    trace = Trace(window_ns=(0, 0), steps=steps)
    device = []
    for e in events:
        annotation = bool(getattr(e, "is_user_annotation", lambda: False)())
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                device.append(e)
            continue
        name = e.name()
        if annotation:
            if name.startswith(SPAN_PREFIX):
                trace.spans.append((start, start + dur, name))
            continue
        if name.startswith("cuda"):  # a runtime call: a launch, a copy, a synchronization
            launch_by_corr[e.correlation_id()] = start
            trace.host_ops.append((start, start + dur, name))
        elif name not in PROFILER_EVENTS:
            corr = e.correlation_id()
            if corr not in ops_by_corr or start < ops_by_corr[corr][1]:
                ops_by_corr[corr] = (name, start)
            trace.host_ops.append((start, start + dur, name))
    for e in device:
        # a kernel carries its launch's correlation id, and links to the
        # host operator in flight at the launch
        op = ops_by_corr.get(e.linked_correlation_id())
        trace.device_ops.append(DeviceOp(
            name=e.name(), start_ns=e.start_ns(), end_ns=e.start_ns() + e.duration_ns(),
            op=op[0] if op else "", launch_ns=launch_by_corr.get(e.correlation_id(), -1)))
    window = [(s, e) for s, e, name in trace.spans if name == window_span]
    if not window:
        raise RuntimeError(f"the profiler recorded no span {window_span!r}")
    trace.window_ns = window[0]
    return trace
