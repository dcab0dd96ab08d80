#!/usr/bin/env python3
"""Where a full-width diffusion train step of the PyTorch port spends its
device time, on one CUDA GPU.

Builds ``DiffusionTrainer`` at the default ``UNet3DConfig`` (the width of
``configs/diffusion_upper_occgrid.json``: 411M parameters, grid 128³×4 and
occupancy 256³, IEEE float32 with TF32 off, no remat) at ``chip_smoke.py``'s
phase-8 cut (batch 1 × grad-acc 2), on seeded random grids, takes one
warm-up step and then one step under ``torch.profiler``.  Each CUDA kernel's
device time is charged to the aten operator that launched it, and the
operators are grouped: convolution (forward, backward and transposed),
GroupNorm (forward and backward), attention (the products and the softmax),
dense (the timestep MLP), the optimizer and EMA (timed apart, in a second
profiled call of ``AdamW.step`` and ``EMA.update``), and elementwise and
the rest.  Prints one JSON line ``{"diffusion_profile": ...}`` with the
step's wall time, the summed kernel time, each group's milliseconds and
share, the launch count and the twelve operators with the most device time.

``--policies`` then times the same step under other precision and memory
policies of ``UNet3DConfig`` (``float32`` / ``bfloat16`` ``compute_dtype``,
``+remat`` for ``remat=True``): one warm-up step and two timed steps each
(host clock around a synchronized step), printed as one JSON line
``{"diffusion_policy": ...}`` per policy with s/step and peak memory.

Usage: ``python3 tools/torch_diffusion_profile.py [--policies
bfloat16,float32+remat,bfloat16+remat]`` from the repository root.
"""
import argparse
import collections
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gshell_tpu_torch.models.unet3d import UNet3DConfig  # noqa: E402
from gshell_tpu_torch.train.diffusion import DiffusionTrainConfig, DiffusionTrainer  # noqa: E402
from gshell_tpu_torch.utils.rng import TorchDraws  # noqa: E402

ATTENTION_OPS = ("aten::bmm", "aten::mm", "aten::_softmax", "aten::_softmax_backward_data")
DENSE_OPS = ("aten::addmm",)


def group_of(op: str) -> str:
    if "conv" in op:
        return "convolution"
    if "group_norm" in op:
        return "group_norm"
    if op in ATTENTION_OPS:
        return "attention"
    if op in DENSE_OPS:
        return "dense"
    return "elementwise_and_other"


def op_device_ms(prof) -> dict:
    """{aten operator: (self device ms, kernel launches)} of the CPU-side
    operators that launched kernels."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0:
            out[e.key] = e.self_device_time_total / 1e3
    return out


def setup(dev, policy: str = "float32"):
    """(trainer, state, batch, draws) at phase 8's cut under ``policy``."""
    d, a, b = 128, 2, 1
    dtype, _, remat = policy.partition("+")
    unet_cfg = dataclasses.replace(UNet3DConfig(), compute_dtype=dtype, remat=remat == "remat")
    trainer = DiffusionTrainer(DiffusionTrainConfig(num_grad_acc_steps=a), unet_cfg, device=dev)
    state = trainer.init_state(TorchDraws(torch.Generator(dev).manual_seed(0)))
    g = torch.Generator(dev).manual_seed(1)
    batch = {"grid": torch.randn((a, b, 4, d, d, d), generator=g, device=dev),
             "occgrid": torch.randn((a, b, 1, 2 * d, 2 * d, 2 * d), generator=g, device=dev)}
    return trainer, state, batch, TorchDraws(torch.Generator(dev).manual_seed(2))


def time_policy(dev, policy: str, card: str) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, state, batch, draws = setup(dev, policy)
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        _, m = trainer.train_step(state, draws.child(f"step{i}"), batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"policy": policy, "steps_s": times, "s_per_step": min(times[1:]), "loss": m["loss"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}


def main():
    from torch.profiler import ProfilerActivity, profile

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--policies", default="", help="comma-separated, e.g. bfloat16,float32+remat")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_diffusion_profile: needs a CUDA device")
    dev = torch.device("cuda:0")
    card = chip_smoke.card_name()
    trainer, state, batch, draws = setup(dev)
    trainer.train_step(state, draws.child("warmup"), batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, draws.child("profiled"), batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kern) / 1e3
    ops = op_device_ms(prof)

    params = list(state.model.parameters())
    grads = [torch.zeros_like(p) for p in params]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_opt:
        state.opt.step(grads)
        state.ema.update(params, trainer.cfg.ema_rate)
        torch.cuda.synchronize()
    opt_ms = sum(op_device_ms(prof_opt).values())

    groups = collections.defaultdict(float)
    for op, ms in ops.items():
        groups[group_of(op)] += ms
    groups["elementwise_and_other"] -= opt_ms
    groups["optimizer_and_ema"] = opt_ms
    total = sum(groups.values())
    print(json.dumps({"diffusion_profile": {
        "config": "UNet3DConfig defaults, grid 128 / occ 256, batch 1 x grad-acc 2, float32 (TF32 off), no remat",
        "wall_ms_profiled": wall_ms, "kernel_ms": kernel_ms, "attributed_ms": total,
        "kernel_launches": sum(e.count for e in kern),
        "groups_ms": dict(groups), "groups_share": {k: v / total for k, v in groups.items()},
        "top_ops": [{"op": k, "ms": v} for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:12]],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card,
    }}), flush=True)
    del trainer, state, batch, params, grads, prof, prof_opt
    for policy in filter(None, args.policies.split(",")):
        print(json.dumps({"diffusion_policy": time_policy(dev, policy, card)}), flush=True)


if __name__ == "__main__":
    main()
