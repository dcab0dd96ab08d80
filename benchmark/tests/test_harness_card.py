"""On the card (marker ``cuda``; skipped without one): the control of each
cell, the reference computed in the precision below the configuration's,
reads at least three times what the program reads on one of the compared
numbers, at the tiny test size, on three seeds.  The full-size readings
behind the limits come from ``python3 -m benchmark.calibrate`` on the card."""
from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.compare import compare

from .tiny import SEED, tiny_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload,dtype", [("tets128_train", "float32"), ("gmd_train", "bfloat16")])
def test_the_control_reads_far_above_the_program(workload, dtype, card, tmp_path):
    found = tiny_cell(workload, tmp_path, compute_dtype=dtype)
    runner = harness.runner_module(found)
    for seed in (SEED, SEED + 1, SEED + 2):
        cell = runner.Cell(found["config_path"], found["traffic"], seed, card)
        n = found["traffic"]["follow_steps"]
        program = cell.follow(n)
        cell.free()
        ref = cell.reference(n)
        spec = found["limits"]["compare"]
        p, c = compare(program, ref, **spec), compare(cell.reference(n, lower=True), ref, **spec)
        assert max(c[k] / max(p[k], 1e-12) for k in p) >= 3.0, (seed, p, c)
