"""The port's own spans (``gshell_tpu_torch.utils.spans``) laid over a
traced window (:class:`benchmark.trace.Trace`).

The program records a span while the profiler records, on the profiler's
clock; the readers here keep the records that lie inside the window and
take the union of the intervals of a set of span names (the host was in
one of them).  Over that union: host milliseconds; device milliseconds and
kernels of the operations launched inside it; device-idle milliseconds
inside it; runtime calls inside it.  Each returns ``None`` where what it
reads is absent: a program without spans, a window without those spans,
or (for the device readers) a trace without device operations."""
from __future__ import annotations

import bisect

# span sets that more than one metric reads
SHADE = {"recon.shade", "recon.shade_backward"}  # the MC walk, its recomputation and its re-walk
UPDATE = {"diffusion.update", "diffusion.ema"}  # AdamW and the EMA


def union(ctx, names) -> list:
    """The merged [start, end] intervals (ns) of the records named ``names``
    inside the window."""
    try:
        from gshell_tpu_torch.utils import spans
    except ImportError:  # a program that records no spans
        return []
    lo, hi = ctx.trace.window_ns
    out = []
    for s, e in sorted((r.start_ns, r.end_ns) for r in spans.recorded()
                       if r.name in names and lo <= r.start_ns and r.end_ns <= hi):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(intervals):
    starts = [s for s, _ in intervals]

    def pred(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= intervals[i][1]
    return pred


def host_ms(ctx, names):
    iv = union(ctx, names)
    return sum(e - s for s, e in iv) * 1e-6 if iv else None


def _device_union(ctx, names):
    return union(ctx, names) if ctx.trace.device_ops else []


def device_ms(ctx, names):
    """Device milliseconds of the operations launched inside the spans."""
    iv = _device_union(ctx, names)
    if not iv:
        return None
    inside = _inside(iv)
    return ctx.trace.device_s_where(lambda o: inside(o.launch_ns)) * 1e3


def launches(ctx, names):
    """Kernels (copies and fills left out) launched inside the spans."""
    iv = _device_union(ctx, names)
    if not iv:
        return None
    inside = _inside(iv)
    return sum(1 for o in ctx.trace.kernels() if inside(o.launch_ns))


def idle_ms(ctx, names):
    """Milliseconds inside the spans in which no device operation ran."""
    iv = _device_union(ctx, names)
    if not iv:
        return None
    busy = ctx.trace.busy_intervals()
    lo, hi = ctx.trace.window_ns
    edges = [lo] + [t for b in busy for t in b] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    total, j = 0, 0
    for s, e in iv:  # both lists sorted and disjoint: one sweep
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < e:
            total += min(e, idle[k][1]) - max(s, idle[k][0])
            k += 1
    return total * 1e-6


def calls(ctx, names, pred):
    """Host runtime calls (``cuda*``) that start inside the spans and whose
    name satisfies ``pred``."""
    iv = _device_union(ctx, names)
    if not iv:
        return None
    inside = _inside(iv)
    return sum(1 for s, _, name in ctx.trace.host_ops if name.startswith("cuda") and pred(name) and inside(s))
