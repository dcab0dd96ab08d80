"""The readers of the port's spans (``benchmark/program_spans.py`` and the
metrics that read it) on a trace and records worked by hand, and whole
tiny runs on the CPU: traced, the host-time metrics report; untraced, the
port records no span."""
from __future__ import annotations

import json
import sys

import pytest
import torch

from benchmark import harness
from benchmark.trace import DeviceOp, Trace
from gshell_tpu_torch.utils import spans

from .tiny import run_tiny, tiny_cell


def rec(i, name, s, e, parent=None):
    return spans.Record(i, name, s, e, parent)


RECORDS = [rec(1, "recon.step", 0, 900), rec(2, "recon.shade", 100, 200, 1), rec(3, "recon.shade", 150, 250, 1),
           rec(4, "recon.shade_backward", 600, 700, 1), rec(5, "recon.shade", 1200, 1300),  # the last after the window
           rec(6, "diffusion.update", 100, 200), rec(7, "diffusion.ema", 600, 700),
           rec(8, "diffusion.forward", 0, 90)]


def hand_ctx(tmp_path, device=True) -> harness.Context:
    # the shade's spans cover [100, 250] and [600, 700]: 250 ns; the device is
    # busy [50, 90], [130, 140], [300, 400], [650, 800], so idle inside them
    # [100, 130], [140, 250], [600, 650]: 190 ns
    dev = [DeviceOp("kernel_a", 300, 400, "aten::a", 110), DeviceOp("kernel_b", 650, 800, "aten::b", 620),
           DeviceOp("Memcpy HtoD", 130, 140, "aten::copy_", 130), DeviceOp("kernel_c", 50, 90, "aten::c", 50)]
    host = [(120, 125, "cudaStreamSynchronize"), (300, 301, "cudaMemcpy"), (610, 615, "cudaMemcpyAsync"),
            (615, 620, "cudaStreamSynchronize"), (950, 960, "cudaDeviceSynchronize"), (20, 22, "aten::empty")]
    trace = Trace(window_ns=(0, 1000), steps=2, device_ops=dev if device else [], host_ops=host if device else [],
                  spans=[(0, 1000, "bench.window")])
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"num_grad_acc_steps": 4}))
    return harness.Context(trace=trace, found={"config_path": str(config)})


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_readers_on_a_hand_built_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(RECORDS))
    ctx = hand_ctx(tmp_path)
    assert read("recon.shade_ms", ctx) == pytest.approx(250e-6 / 2)
    assert read("recon.shade_launches_per_step", ctx) == 1.0  # kernel_a and kernel_b; the copy is no kernel
    assert read("recon.shade_idle_ms", ctx) == pytest.approx(190e-6 / 2)
    # inside recon.step: both stream synchronizations and the blocking copy
    assert read("recon.host_syncs_per_step", ctx) == 1.5
    assert read("recon.forward_ms", ctx) is None  # no such span in the window
    # launched in the update's spans: kernel_a (at 110 ns), the copy (130) and kernel_b (620)
    assert read("train.update_ms", ctx) == pytest.approx((100 + 150 + 10) * 1e-6 / 2)
    assert read("train.update_idle_ms", ctx) == pytest.approx((30 + 60 + 50) * 1e-6 / 2)
    # kernel_c, launched at 50 ns in diffusion.forward, over 2 steps × 4 micro-steps
    assert read("train.forward_ms", ctx) == pytest.approx(40e-6 / 8)


def test_without_a_device_trace_only_host_time_reports(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(RECORDS))
    ctx = hand_ctx(tmp_path, device=False)
    assert read("recon.shade_ms", ctx) == pytest.approx(250e-6 / 2)
    for name in ("recon.shade_launches_per_step", "recon.shade_idle_ms", "recon.host_syncs_per_step",
                 "train.update_ms", "train.update_idle_ms", "train.forward_ms"):
        assert read(name, ctx) is None, name


def test_a_program_without_spans_reports_nothing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "gshell_tpu_torch.utils.spans", None)  # its import fails
    ctx = hand_ctx(tmp_path)
    for name in ("recon.shade_ms", "recon.shade_idle_ms", "recon.host_syncs_per_step", "train.update_ms"):
        assert read(name, ctx) is None, name


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_a_traced_tiny_run_reports_the_host_time_of_the_step(tmp_path, capsys, few_threads):
    before = len(spans.recorded())
    line = run_tiny(tiny_cell("tets128_train", tmp_path), capsys, trace=1)
    got = line["metrics"]
    phases = ("recon.forward_ms", "recon.backward_ms", "recon.update_ms")
    assert set(phases + ("recon.extract_ms", "recon.shade_ms")) <= set(got)
    assert not {"recon.shade_launches_per_step", "recon.shade_idle_ms", "recon.host_syncs_per_step"} & set(got)
    window_ms = line["device"]["window_s"] * 1e3  # one traced step
    assert 0 < sum(got[p]["value"] for p in phases) <= window_ms
    assert 0 < got["recon.shade_ms"]["value"] < got["recon.forward_ms"]["value"] + got["recon.backward_ms"]["value"]
    assert len(spans.recorded()) > before


def test_an_untraced_run_records_no_span(tmp_path, capsys, few_threads):
    before = spans.recorded()
    run_tiny(tiny_cell("tets128_train", tmp_path), capsys, trace=0)
    assert spans.recorded() == before
