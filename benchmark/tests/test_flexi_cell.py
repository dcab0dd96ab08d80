"""The FlexiCubes cell at a tiny size on the CPU: a whole run through
``harness.measure`` agrees with the plain reference, a broken step makes
``correct`` false, and the cell's per-layer readers give what a trace and
records worked by hand say."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import harness
from benchmark.trace import DeviceOp, Trace
from gshell_tpu_torch.geometry import flexi_geometry
from gshell_tpu_torch.utils import spans

from .tiny import run_tiny

WORKLOAD = "flexi80_train"
# tiny sizes (test sizes, not a cell): widths and depths cut, every path kept
FLEXI = {"voxel_grid": 8, "gshell_grid": 8, "train_res": [48, 48], "n_samples": 2, "d_hidden": 32, "n_hidden": 2,
         "skip_in": [1]}
FLEXI_TRAFFIC = {"n_views": 4, "shape_fit_steps": 100, "shape_fit_points": 2048, "trace_steps": 1,
                 "adam_moments": {"step": 0, "first": 0.1, "second": [0.5, 1.5],
                                  "grad_rms": {"deform": 1e-4, "cube_weights": 1e-4, "msdf": 1e-4, "sdf_net": 1e-2,
                                               "tables": 1e-5, "mlp": 1e-7, "light": 1e-4}}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def tiny_flexi(tmp_path) -> dict:
    """``harness.find_cell`` of the cell with its configuration and traffic
    cut to the tiny sizes."""
    found = harness.find_cell(WORKLOAD)
    cfg = dict(found["config_file"], **FLEXI)
    found["traffic"] = dict(found["traffic"], **FLEXI_TRAFFIC)
    path = os.path.join(str(tmp_path), WORKLOAD + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    found["config_path"], found["config_file"] = path, cfg
    return found


def test_port_and_reference_agree_at_a_tiny_size(tmp_path, capsys):
    line = run_tiny(tiny_flexi(tmp_path), capsys)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    for name, c in line["compared"].items():
        assert c["value"] <= 1e-5, (name, c)
    assert {"setup_s", "recon_it_per_s"} <= set(line["metrics"]) and line["device"]["memory_peak_bytes"] is None


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_makes_correct_false(fault, tmp_path, capsys):
    line = run_tiny(tiny_flexi(tmp_path), capsys, fault=fault)
    assert line["correct"] is False
    assert [n for n, c in line["compared"].items() if c["value"] > c["limit"]], line["compared"]
    if fault == "unchanged":
        assert line["compared"]["change"]["value"] == pytest.approx(1.0)


def test_a_traced_run_reads_the_slot_fill_and_no_device_metric_on_the_cpu(tmp_path, capsys):
    line = run_tiny(tiny_flexi(tmp_path), capsys, trace=1)
    host = {"recon.forward_ms", "recon.backward_ms", "recon.update_ms", "recon.extract_ms", "recon.shade_ms"}
    assert set(line["metrics"]) == host | {"flexi.slot_fill_pct"}
    assert 0 < line["metrics"]["flexi.slot_fill_pct"]["value"] < 100


# ---------------- the readers, on traces and records worked by hand ----------------

def ctx_of(device=True, **kw):
    ops = [DeviceOp("tanh", 100, 110, "aten::tanh", 95), DeviceOp("index", 120, 150, "aten::index", 98),
           DeviceOp("tanh_backward", 300, 340, "aten::tanh_backward", 250),
           DeviceOp("index_put", 400, 500, "aten::index_put_", 390),
           DeviceOp("sgemm", 600, 900, "aten::mm", 590)]
    trace = Trace(window_ns=(0, 1000), steps=2, device_ops=ops if device else [], spans=[(0, 1000, "bench.window")])
    return harness.Context(trace=trace, found={}, **kw)


RECORDS = [spans.Record(1, "recon.extract", 80, 200, None), spans.Record(2, "recon.flexi_extract", 90, 100, 1),
           spans.Record(3, "recon.backward", 240, 990, None),
           spans.Record(4, "recon.flexi_extract_backward", 245, 260, 3),
           spans.Record(5, "recon.flexi_extract_backward", 380, 395, 3)]


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_the_extraction_readers_take_the_device_time_launched_inside_their_spans(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: RECORDS)
    assert read("flexi.extract_ms", ctx_of()) == pytest.approx((10 + 30) * 1e-6 / 2)
    assert read("flexi.extract_bwd_ms", ctx_of()) == pytest.approx((40 + 100) * 1e-6 / 2)


def test_the_extraction_readers_report_nothing_without_their_spans_or_a_device_trace(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: RECORDS[:1] + RECORDS[2:3])
    assert read("flexi.extract_ms", ctx_of()) is None and read("flexi.extract_bwd_ms", ctx_of()) is None
    monkeypatch.setattr(spans, "recorded", lambda: RECORDS)
    assert read("flexi.extract_ms", ctx_of(False)) is None and read("flexi.extract_bwd_ms", ctx_of(False)) is None


def test_the_slot_fill_reads_the_counts_logged_inside_the_window(monkeypatch):
    row = {"max_cubes": 1000, "quad_edges": 5, "max_edges": 800, "faces": 9, "face_cap": 3200}
    rows = [dict(row, time_ns=-5, surface_cubes=999), dict(row, time_ns=400, surface_cubes=150),
            dict(row, time_ns=900, surface_cubes=160), dict(row, time_ns=1500, surface_cubes=999)]
    monkeypatch.setattr(flexi_geometry, "slot_counts", lambda: rows)
    assert read("flexi.slot_fill_pct", ctx_of()) == pytest.approx(100 * 310 / 2000)
    monkeypatch.setattr(flexi_geometry, "slot_counts", lambda: rows[:1])
    assert read("flexi.slot_fill_pct", ctx_of()) is None


def test_the_step_mfu_counts_the_references_evaluations(tmp_path):
    from benchmark.metrics.recon_step_mfu import step_flops
    from benchmark.yardstick import PEAK_FLOPS

    found = harness.find_cell(WORKLOAD)
    evaluations = [("sdf", 531441, True), ("eikonal", 50000, True), ("material", 2_000_000, True)]
    ctx = ctx_of(reference={"evaluations": evaluations}, window_s=50.0, window_steps=5, on_card=True)
    ctx.found = found
    flops = step_flops(found["config_path"], evaluations)
    assert flops == pytest.approx(3 * 531441 * 826_880 + 6 * 50000 * 826_880 + 3 * 2_000_000 * 4_480, rel=1e-3)
    assert read("recon_step_mfu", ctx) == pytest.approx(100 * flops / 10.0 / PEAK_FLOPS["float32"])
    ctx.on_card = False
    assert read("recon_step_mfu", ctx) is None
