"""Whole runs of each cell at a tiny size on the CPU, through
``harness.measure``: the port and the plain reference agree; with the
timed path broken underneath (a step that leaves the state unchanged; half
of the batch left out, the mean taken over the rest) ``correct`` comes out
false; the control (the reference in the precision below the
configuration's) reads far above the program."""
from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.compare import compare

from .tiny import SEED, run_tiny, tiny_cell

CELLS = ["tets128_train", "gmd_train"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_port_and_reference_agree_at_a_tiny_size(workload, tmp_path, capsys):
    line = run_tiny(tiny_cell(workload, tmp_path), capsys)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "compared"
    for name, c in line["compared"].items():
        assert c["value"] <= 1e-5, (name, c)
    rate = harness.find_cell(workload)["traffic"]["rate_metric"]
    assert {"setup_s", rate} <= set(line["metrics"]) and line["device"]["memory_peak_bytes"] is None


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_makes_correct_false(workload, fault, tmp_path, capsys):
    line = run_tiny(tiny_cell(workload, tmp_path), capsys, fault=fault)
    assert line["correct"] is False
    over = [n for n, c in line["compared"].items() if c["value"] > c["limit"]]
    assert over, line["compared"]
    if fault == "unchanged":
        assert line["compared"]["change"]["value"] == pytest.approx(1.0)


def test_the_fp8_control_reads_far_above_the_program_on_the_cpu(tmp_path):
    """The diffusion cell's control needs no card: float8 operands are a
    rounding done in plain PyTorch.  (TF32, the reconstruction cell's
    control, exists only on the card: ``test_harness_card.py``.)"""
    found = tiny_cell("gmd_train", tmp_path, compute_dtype="bfloat16")
    runner = harness.runner_module(found)
    cell = runner.Cell(found["config_path"], found["traffic"], SEED, torch.device("cpu"))
    program = cell.follow(3)
    cell.free()
    ref = cell.reference(3)
    ctrl = cell.reference(3, lower=True)
    p, c = compare(program, ref, **found["limits"]["compare"]), compare(ctrl, ref, **found["limits"]["compare"])
    assert max(c[k] / max(p[k], 1e-12) for k in p) >= 3.0, (p, c)
