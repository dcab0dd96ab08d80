"""Benchmark of the port: the full G-Shell reconstruction train step on one
GPU (PyTorch twin of the repository's ``bench.py``).

Measures iterations/s of the complete reconstruction step (G-Shell tet
extraction, rasterization, Monte-Carlo PBR shading with mesh-splat shadows
and the bilateral denoiser, the backward, three Adam groups) at the
reference's DeepFashion working point scaled to one card: tet grid 64,
512², batch 2, n_samples 8 (``configs/deepfashion_mc.json`` scale).

Usage::

    python -m gshell_tpu_torch.bench [--quick] [--one RES,GRID,SPP,BATCH] [--device cuda|cpu]

Without ``--one`` it runs 512,64,8,2 (128,32,2,1 under ``--quick``).  It
runs on the card unless ``--device cpu`` is given; without a card it exits
non-zero.  Prints ONE JSON line on stdout::

    {"metric": "gshell_train_step_iters_per_sec(res{R},grid{G},spp{S},b{B})",
     "value": it/s, "unit": "iters/sec", "vs_baseline": value / 2.5,
     "compile_sec": s, "achieved_tflops": x, "mfu": x, "device": name}

and everything else on ``#`` lines on stderr.  The numbers are not rounded.

* ``vs_baseline`` divides by 2.5 it/s, the JAX bench's *assumed* A100
  figure for this configuration (nvdiffrecmc-class pipelines at 512²/8 spp,
  batch 2): an assumption, not a measurement.
* ``compile_sec`` is the host seconds of the warm-up step (state step 0).
  There is no compilation; in a fresh process it includes the hand kernels'
  build at first use, whose ``nvcc`` seconds a ``#`` line gives.  Then 20
  steps (5 under ``--quick``), state steps 1–20, are timed on the host clock
  up to ``torch.cuda.synchronize()``.  The state stays at step 0 after its
  SDF pretrain, as in the JAX bench, so the timed steps run with the shadow
  ramp ``it / 1000`` and denoiser σ ``max(2·it / 1000, 1e-4)``.
* ``achieved_tflops`` and ``mfu`` come from one more step after the timed
  ones, not timed, run under ``torch.utils.flop_counter.FlopCounterMode``:
  it counts the matrix products and the convolutions only, not the gathers,
  the elementwise work or the two hand kernels, so the share understates
  the work.  The JAX bench's figure came from XLA's cost model of every HLO
  operation; the two cannot be compared.  ``mfu`` is against 67 TFLOP/s,
  an H100 SXM's float32 rate outside the tensor cores (the step runs with
  TF32 off, ``train/reconstruct.py``), and is null off the card.
* Left out: ``hbm_util`` (XLA's "bytes accessed" has no PyTorch
  counterpart), the JAX bench's compile-only mode, its TPU probe and its
  subprocess ladder.

The seven ablation variables of the JAX bench are read with its defaults:
``GSHELL_VIEW_MODE`` (map), ``GSHELL_CAP_SAFETY`` (1.0),
``GSHELL_SHADE_BUDGET`` (0.5; ≤ 0 turns the foreground compaction off),
``GSHELL_BSDF`` (pbr), ``GSHELL_NO_DENOISER`` (any non-empty value),
``GSHELL_JITTER_TAP`` (0.25) and ``GSHELL_MC_BLOCK`` (8).

A deliberate difference: the port has no ``tiled_raster``, ``raster_chunk``
or ``max_per_tile``; its stage B is uncapped and runs wherever the
resolution is a multiple of 16.  So under ``--quick`` at 128² the port
rasterizes through the stage-B kernel where the JAX bench runs the scan.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from .geometry.geometry import GeometryConfig, GShellGeometry
from .ops import math as gm
from .ops.hashgrid import HashGridConfig
from .render.material import MLPTexture3DConfig, default_kd_ks_min_max
from .render.render import RenderFlags
from .train.reconstruct import Reconstructor, TrainConfig
from .train.setup import kernel_launches, launches_since, resolve_device, sync
from .utils import kernels
from .utils.rng import TorchDraws

PROG = "gshell_tpu_torch.bench"
WORKING_POINT = (512, 64, 8, 2)  # res, tet grid, n_samples, batch
QUICK_POINT = (128, 32, 2, 1)
BASELINE_A100_ITS = 2.5  # assumed, not measured (see the module docstring)
FP32_PEAK_TFLOPS = 67.0  # H100 SXM, float32 outside the tensor cores, at 700 W


def bench_configs(quick: bool, res: int, grid: int, n_samples: int, batch: int, env=None):
    """(GeometryConfig, MLPTexture3DConfig, RenderFlags, TrainConfig,
    pretrain steps) with the JAX bench's values; ``env`` (default
    ``os.environ``) supplies the ablation variables."""
    env = os.environ if env is None else env
    gcfg = GeometryConfig(
        grid_res=grid, use_sdf_mlp=True, use_eikonal=True, n_eikonal_samples=2048 if quick else 16384,
        total_iters=5000, view_batch_mode=env.get("GSHELL_VIEW_MODE", "map"),
        capacity_safety=float(env.get("GSHELL_CAP_SAFETY", "1.0")),
    )
    mat_cfg = MLPTexture3DConfig(channels=6, hash=HashGridConfig(), min_max=default_kd_ks_min_max())
    budget = float(env.get("GSHELL_SHADE_BUDGET", "0.5"))
    flags = RenderFlags(
        resolution=(res, res), n_samples=n_samples, bsdf=env.get("GSHELL_BSDF", "pbr"),
        use_denoiser=not quick and not env.get("GSHELL_NO_DENOISER"),
        shade_budget=budget if budget > 0 else None,
        jitter_tap_frac=float(env.get("GSHELL_JITTER_TAP", "0.25")),
        mc_block=int(env.get("GSHELL_MC_BLOCK", "8")),
    )
    tcfg = TrainConfig(batch=batch, use_shadows=True)
    return gcfg, mat_cfg, flags, tcfg, 100 if quick else 1000


def make_target(res: int, batch: int, device) -> dict:
    """The JAX bench's synthetic target: a grey disk of radius 0.3·res on
    black, seen from (0, 0, 2.5), the same view ``batch`` times."""
    proj = gm.perspective(math.radians(45.0), 1.0, 0.1, 1000.0, device=device)
    view = gm.lookat(torch.tensor([0.0, 0.0, 2.5], device=device), torch.zeros(3, device=device),
                     torch.tensor([0.0, 1.0, 0.0], device=device))
    ys, xs = torch.meshgrid(torch.arange(res, device=device), torch.arange(res, device=device), indexing="ij")
    r = torch.sqrt((xs - res / 2) ** 2 + (ys - res / 2) ** 2)
    mask = (r < 0.3 * res).float()[None, ..., None].repeat(batch, 1, 1, 1)
    return {
        "mvp": (proj @ view)[None].repeat(batch, 1, 1),
        "campos": torch.tensor([[0.0, 0.0, 2.5]], device=device).repeat(batch, 1),
        "img": torch.cat([torch.ones((batch, res, res, 3), device=device) * 0.5 * mask, mask], -1),
        "background": torch.zeros((batch, res, res, 3), device=device),
    }


def build(quick: bool, res: int, grid: int, n_samples: int, batch: int, device, seed: int = 0):
    """(Reconstructor, state at step 0 after the SDF pretrain, draws,
    target) of the bench's configuration on ``device``."""
    gcfg, mat_cfg, flags, tcfg, pretrain = bench_configs(quick, res, grid, n_samples, batch)
    rec = Reconstructor(GShellGeometry(gcfg, device), mat_cfg, flags, tcfg)
    draws = TorchDraws(torch.Generator(device).manual_seed(seed))
    state = rec.init_state(draws.child("init"), pretrain_steps=pretrain)
    return rec, state, draws, make_target(res, batch, device)


def run_config(quick: bool, res: int, grid: int, n_samples: int, batch: int, device) -> dict:
    """Build, warm up, time and count one configuration; print its line.
    Returns the record: the line, the loss, the peak memory, the kernels'
    launches per phase (``launches``) and per timed step (``step_launches``)."""
    from torch.utils.flop_counter import FlopCounterMode

    c0 = kernel_launches()
    rec, state, draws, target = build(quick, res, grid, n_samples, batch, device)
    sync(device)
    launches = {"init": launches_since(c0)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    c0, t0 = kernel_launches(), time.time()
    rec.train_step(state, draws.child("step0"), target)
    sync(device)
    compile_sec = time.time() - t0
    launches["warmup"] = launches_since(c0)
    print(f"# warm-up step (state step 0): {compile_sec:.3f} s; hand kernels built by nvcc in this process in "
          f"{kernels.build_seconds} s (0.0: found built on disk, None: no kernel ran)", file=sys.stderr)

    n_iters = 5 if quick else 20
    step_launches = []
    c0, t0 = kernel_launches(), time.time()
    for i in range(1, n_iters + 1):
        ci = kernel_launches()
        m = rec.train_step(state, draws.child(f"step{i}"), target)
        step_launches.append(launches_since(ci))
    sync(device)
    dt = time.time() - t0
    launches["timed"] = launches_since(c0)
    ips = n_iters / dt
    loss, ntets = float(m["total"]), int(m["n_valid_tets"])
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None

    c0 = kernel_launches()
    with FlopCounterMode(display=False) as counter:
        rec.train_step(state, draws.child(f"step{n_iters + 1}"), target)
    sync(device)
    launches["flops"] = launches_since(c0)
    tflops = counter.get_total_flops() * ips / 1e12

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {
        "metric": f"gshell_train_step_iters_per_sec(res{res},grid{grid},spp{n_samples},b{batch})",
        "value": ips,
        "unit": "iters/sec",
        "vs_baseline": ips / BASELINE_A100_ITS,
        "compile_sec": compile_sec,
        "achieved_tflops": tflops,
        "mfu": tflops / FP32_PEAK_TFLOPS if device.type == "cuda" else None,
        "device": name,
    }
    print(json.dumps(out), flush=True)
    peak = "not measured (CPU)" if peak_gib is None else f"{peak_gib:.2f} GiB"
    print(f"# compile={compile_sec:.1f}s loss={loss:.5f} ntets={ntets} device={name} peak={peak} "
          f"launches={json.dumps(launches)}", file=sys.stderr)
    return {"line": out, "loss": loss, "n_valid_tets": ntets, "peak_gib": peak_gib, "launches": launches,
            "step_launches": step_launches}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="5 steps, 100 pretrain steps, no denoiser")
    p.add_argument("--one", type=str, default=None, metavar="RES,GRID,SPP,BATCH",
                   help="the configuration (default 512,64,8,2; 128,32,2,1 under --quick)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.one is None:
        cfg = QUICK_POINT if args.quick else WORKING_POINT
    else:
        try:
            cfg = tuple(int(v) for v in args.one.split(","))
        except ValueError:
            cfg = ()
        if len(cfg) != 4:
            p.error(f"--one {args.one!r}: four integers RES,GRID,SPP,BATCH")
    return run_config(args.quick, *cfg, resolve_device(args.device, PROG))


if __name__ == "__main__":
    main()
