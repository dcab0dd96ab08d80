"""``recon.gather_bwd_ms`` on a trace and records worked by hand: the device
time of the operations launched inside ``recon.gather_backward``, and
nothing where the program records no such span."""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.trace import DeviceOp, Trace
from gshell_tpu_torch.utils import spans


def ctx_of(device=True):
    ops = [DeviceOp("fill", 100, 110, "aten::zero_", 95), DeviceOp("scatter_rows_kernel", 120, 150, "", 98),
           DeviceOp("indexing_backward_kernel", 300, 500, "aten::index_put_", 250)]
    trace = Trace(window_ns=(0, 1000), steps=2, device_ops=ops if device else [],
                  spans=[(0, 1000, "bench.window")])
    return harness.Context(trace=trace, found={})


def read(ctx):
    return harness.metric_reader("recon.gather_bwd_ms")(ctx)


def test_reads_the_device_time_launched_inside_the_span(monkeypatch):
    records = [spans.Record(1, "recon.backward", 0, 900, None), spans.Record(2, "recon.gather_backward", 90, 99, 1)]
    monkeypatch.setattr(spans, "recorded", lambda: records)
    assert read(ctx_of()) == pytest.approx((10 + 30) * 1e-6 / 2)


def test_reports_nothing_without_the_span_or_without_a_device_trace(monkeypatch):
    records = [spans.Record(1, "recon.backward", 0, 900, None)]
    monkeypatch.setattr(spans, "recorded", lambda: records)
    assert read(ctx_of()) is None
    records.append(spans.Record(2, "recon.gather_backward", 90, 99, 1))
    assert read(ctx_of(device=False)) is None
