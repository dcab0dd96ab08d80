"""The reduction of a profiler window (``benchmark/trace.py``) on a trace
worked by hand: busy and idle time, device time charged to a span, and
idle gaps named by the innermost host operator in flight."""
from __future__ import annotations

import pytest

from benchmark.trace import DeviceOp, Trace


def hand_trace() -> Trace:
    # host: a span around an op holding two launches; the device runs two
    # kernels and a copy, overlapping the first two, with a gap the op covers
    host = [(0, 100, "aten::op"), (10, 12, "cudaLaunchKernel"), (60, 62, "cudaLaunchKernel")]
    spans = [(0, 50, "bench.opt_ema"), (0, 120, "bench.window")]
    dev = [DeviceOp("kernel_a", 20, 40, "aten::op", 10), DeviceOp("kernel_b", 30, 45, "aten::op", 11),
           DeviceOp("Memcpy HtoD", 70, 80, "aten::op", 60)]
    return Trace(window_ns=(0, 120), steps=2, device_ops=dev, host_ops=host, spans=spans)


def test_busy_idle_and_kernels():
    tr = hand_trace()
    assert tr.busy_intervals() == [[20, 45], [70, 80]]
    assert tr.busy_s() == pytest.approx(35e-9)
    assert tr.idle_pct() == pytest.approx(100 * (1 - 35 / 120))
    assert [o.name for o in tr.kernels()] == ["kernel_a", "kernel_b"]


def test_device_time_charged_to_a_span_by_launch_time():
    tr = hand_trace()
    assert tr.device_s_where(tr.in_span("bench.opt_ema")) == pytest.approx(35e-9)
    assert tr.device_s_where(lambda o: "op" in o.op) == pytest.approx(45e-9)


def test_idle_gaps_are_named_by_the_innermost_host_operator():
    gaps = dict(hand_trace().idle_gaps())
    # a gap is named at its start: 0-20 and 45-70 start inside the span bench.opt_ema (0-50), the
    # innermost interval open then; 80-120 starts inside aten::op, its launches long ended
    assert gaps == {"bench.opt_ema": pytest.approx(45e-9), "aten::op": pytest.approx(40e-9)}
