"""Tiny sizes of the benchmark's cells, for runs on the CPU: the widths
and depths cut (these are test sizes, not cells), every path kept."""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from benchmark import harness

RECON = {"gshell_grid": 16, "train_res": [64, 64], "n_samples": 2, "d_hidden": 32, "n_hidden": 2, "skip_in": [1]}
RECON_TRAFFIC = {"n_views": 4, "shape_fit_steps": 100, "shape_fit_points": 2048, "trace_steps": 1,
                 "adam_moments": {"step": 0, "first": 0.1, "second": [0.5, 1.5],  # by group: the tiny net has fewer layers
                                  "grad_rms": {"deform": 1e-4, "msdf": 1e-4, "sdf_net": 1e-2, "tables": 1e-5,
                                               "mlp": 1e-7, "light": 1e-4}}}
DIFFUSION = {"grid_size": 64, "base_channels": 8, "ch_mult": [1, 1, 1, 1, 1, 1], "num_grad_acc_steps": 2,
             "batch": 8}
DIFFUSION_TRAFFIC = {"pool_shapes": 2, "trace_steps": 1}
SEED = 2 ** 31 + 977


def tiny_cell(workload: str, tmp_path, compute_dtype: str = "float32") -> dict:
    """``harness.find_cell(workload)`` with its configuration and traffic
    cut to the tiny sizes (the configuration written under ``tmp_path``)."""
    found = harness.find_cell(workload)
    cfg = dict(found["config_file"])
    if cfg["runner"] == "reconstruction":
        cfg.update(RECON)
        found["traffic"] = dict(found["traffic"], **RECON_TRAFFIC)
    else:
        cfg.update(DIFFUSION, compute_dtype=compute_dtype)
        found["traffic"] = dict(found["traffic"], **DIFFUSION_TRAFFIC)
    path = os.path.join(str(tmp_path), workload + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    found["config_path"], found["config_file"] = path, cfg
    return found


def run_tiny(found: dict, capsys, fault=None, trace: int = 0, seed: int = SEED) -> dict:
    """One run of ``found`` on the CPU through ``harness.measure`` → its
    result line."""
    torch.manual_seed(0)
    args = argparse.Namespace(workload=found["cell"]["name"], seed=seed, seconds=0.5, trace=trace, fault=fault)
    rc = harness.measure(args, found, torch.device("cpu"), time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
