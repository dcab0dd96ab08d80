"""G-MeshDiffusion train-step throughput on one GPU (PyTorch twin of the
repository's ``tools/bench_diffusion.py``).

Reference working point (SURVEY §2.5, BASELINE.md): the dual-head UNet3D on
(4, 128³) feature grids and (1, 256³) occupancy grids, a global batch of
8 ranks × 1 × 4 accumulation steps, 2.4M optimizer steps.  This measures
one micro-step (a (b, 128³) + (b, 256³) forward, backward and update) and
projects the recipe onto eight of this card: data parallel over 8 GPUs
replaces the 8 ranks and the 4 accumulation steps stay sequential, so

    wall(recipe) ≈ 2.4M × 4 × t_micro

Usage::

    python -m gshell_tpu_torch.bench_diffusion [grid] [batch] [n_iters] [--device cuda|cpu]

(defaults 64, 1, 10).  The U-Net is the default one with each ResBlock
recomputed in the backward and bfloat16 autocast (parameters float32),
trained by the monolithic step; inputs are all 0.1.  The first step is
timed as ``compile_sec`` (no compilation: cuDNN's first calls and the
allocator's growth), then ``n_iters`` steps up to a sync.  Prints ONE JSON
line on stdout, not rounded::

    {"metric": "gmeshdiffusion_train_step(grid{d},occ{2d},b{b})", "value": ms/step,
     "unit": "ms/step", "iters_per_sec", "params_M", "compile_sec",
     "recipe_2p4M_days_h100x8", "achieved_tflops", "mfu", "device"}

``achieved_tflops`` counts model FLOPs, ``models/unet3d.forward_flops`` × 3
× b a step (remat's recomputed forward not counted), over the step time;
``mfu`` divides it by the card's dense peak for the compute dtype; both
it and the projection are null off the card.  There is no ``hbm_util``
and no segmented step.  Runs on the card unless ``--device cpu`` is
given; without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .models.unet3d import UNet3DConfig, forward_flops
from .train.diffusion import DiffusionTrainConfig, DiffusionTrainer
from .train.setup import resolve_device, sync
from .utils.rng import TorchDraws

PROG = "gshell_tpu_torch.bench_diffusion"
UNET = UNet3DConfig(data_ch=4, use_occ=True, remat=True, compute_dtype="bfloat16")
# Dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet): bf16 on the
# tensor cores, float32 outside them.
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}
RECIPE_STEPS, RECIPE_ACCUM = 2.4e6, 4  # the reference config's steps and accumulation


def run(d: int, b: int, n: int, device, unet_cfg: UNet3DConfig = UNET) -> dict:
    """Time ``n`` steps at grid ``d``, batch ``b``; print and return the line."""
    cfg = DiffusionTrainConfig(data_ch=unet_cfg.data_ch, use_occ=True, num_grad_acc_steps=1, warmup=10)
    trainer = DiffusionTrainer(cfg, unet_cfg, device=device)
    draws = TorchDraws(torch.Generator(device).manual_seed(0))
    state = trainer.init_state(draws.child("init"))
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"# UNet3D params: {n_params / 1e6:.1f}M  grid {d}^3 occ {2 * d}^3 batch {b}", file=sys.stderr)
    batch = {"grid": torch.full((1, b, unet_cfg.data_ch, d, d, d), 0.1, device=device),
             "occgrid": torch.full((1, b, 1, 2 * d, 2 * d, 2 * d), 0.1, device=device)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.time()
    state, m = trainer.train_step(state, draws.child("step0"), batch)
    sync(device)
    compile_sec = time.time() - t0
    print(f"# first step: {compile_sec:.1f}s loss={m['loss']:.4f}", file=sys.stderr)
    t0 = time.time()
    for i in range(1, n + 1):
        state, m = trainer.train_step(state, draws.child(f"step{i}"), batch)
    sync(device)
    dt = (time.time() - t0) / n

    tflops = 3 * b * forward_flops(unet_cfg, d) / dt / 1e12
    card = device.type == "cuda"
    out = {
        "metric": f"gmeshdiffusion_train_step(grid{d},occ{2 * d},b{b})",
        "value": dt * 1000.0,
        "unit": "ms/step",
        "iters_per_sec": 1.0 / dt,
        "params_M": n_params / 1e6,
        "compile_sec": compile_sec,
        "recipe_2p4M_days_h100x8": RECIPE_STEPS * RECIPE_ACCUM * dt / 86400.0 if card else None,
        "achieved_tflops": tflops,
        "mfu": tflops / PEAK_TFLOPS[unet_cfg.compute_dtype] if card else None,
        "device": torch.cuda.get_device_name(device) if card else "cpu",
    }
    print(json.dumps(out), flush=True)
    if card:
        print(f"# peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; last loss {m['loss']:.4f}",
              file=sys.stderr)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    p.add_argument("grid", type=int, nargs="?", default=64, help="feature grid side (default 64)")
    p.add_argument("batch", type=int, nargs="?", default=1, help="samples a step (default 1)")
    p.add_argument("n_iters", type=int, nargs="?", default=10, help="timed steps (default 10)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.n_iters < 1:
        p.error("n_iters must be >= 1")
    return run(args.grid, args.batch, args.n_iters, resolve_device(args.device, PROG))


if __name__ == "__main__":
    main()
