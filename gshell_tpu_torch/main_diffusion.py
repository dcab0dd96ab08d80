"""G-MeshDiffusion command line of the port (twin of ``main_diffusion.py``).

Modes:
  train             — DDPM training with gradient accumulation, EMA and a
                      rolling ``checkpoints-meta.pt`` snapshot
  uncond_gen        — unconditional sampling (DDIM or PC) with the EMA weights
                      → ``sample_XXXX.npz``
  uncond_gen_interp — slerp between two prior noises, each interpolant
                      decoded by the same DDIM → ``interp_PPPP_XX.npz``
  cond_gen          — inpainting from ``--cond-file`` (``grid`` + ``cond_mask``,
                      optionally ``occgrid`` + ``occ_cond_mask``)
                      → ``cond_sample_XXXX.npz``

Usage:
  python -m gshell_tpu_torch.main_diffusion --mode train --data-glob 'baked/*.npz' \\
      --mask-file baked/masks.npz --workdir out/diffusion
  python -m gshell_tpu_torch.main_diffusion --mode uncond_gen --workdir out/diffusion

Every mode restores ``WORKDIR/checkpoints-meta.pt`` when it exists, so a
second ``train`` goes on from the saved step.  Step ``s`` takes its draws
from a generator seeded with (``--seed``, s) and its files from
``np.random.default_rng((seed, s))``, so a resumed run sees what a straight
run sees.  ``.npz`` files are in the JAX package's channels-last layout
(grids and samples pass between the packages unchanged).  With
``--mask-file`` the samplers mask every step, as the sampler API does.
Runs on ``--device cuda`` unless given ``--device cpu``.

Several processes (``--multihost``, JAX's flag): one process per GPU in a
``torch.distributed`` group, from ``torchrun`` (``torchrun
--nproc-per-node N -m gshell_tpu_torch.main_diffusion --multihost …``) or
with ``--coordinator host:port --num-processes N --process-id R`` on each.
The backend is NCCL on ``cuda`` and gloo on ``cpu``; ``--dist-backend
gloo`` puts several ranks on one card (NCCL refuses two ranks on one
device).  Rank r trains on rows [r·B/W, (r+1)·B/W) of each global batch of
``--batch``, opening only their files; rank 0 alone prints, writes the
checkpoint and the samples.
"""
from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .data.grids import GridSampler
from .data.multihost import DistributedGridSampler
from .models.evaler import cond_gen, uncond_gen, uncond_gen_interp
from .models.sampling import get_ddim_sampler, get_pc_sampler
from .models.unet3d import UNet3DConfig, n_params
from .parallel.sharding import init_multihost, make_mesh, rank_device
from .train.diffusion import DiffusionTrainConfig, DiffusionTrainer
from .train.setup import resolve_device
from .utils.rng import TorchDraws

PROG = "gshell_tpu_torch.main_diffusion"
N_INTERP = 8  # interpolants per pair in uncond_gen_interp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=PROG, description="G-MeshDiffusion (PyTorch port)")
    p.add_argument("--mode", choices=["train", "uncond_gen", "uncond_gen_interp", "cond_gen"], required=True)
    p.add_argument("--cond-file", type=str, default=None,
                   help="cond_gen: .npz with 'grid' (known values) + 'cond_mask'")
    p.add_argument("--workdir", type=str, default="out/diffusion")
    p.add_argument("--data-glob", type=str, default=None, help="glob of .npz baked grids")
    p.add_argument("--grid-size", type=int, default=128)
    p.add_argument("--data-ch", type=int, default=4)
    p.add_argument("--n-iters", type=int, default=2400001)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--grad-acc", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--snapshot-freq", type=int, default=1000)
    p.add_argument("--log-freq", type=int, default=50)
    p.add_argument("--sampling-method", choices=["pc", "ddim"], default="ddim")
    p.add_argument("--n-sampling-steps", type=int, default=100)
    p.add_argument("--n-samples", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mask-file", type=str, default=None,
                   help=".npz with feature_mask/occ_mask (as bake_grids writes it)")
    p.add_argument("--base-channels", type=int, default=None)
    p.add_argument("--ch-mult", type=str, default=None, help="comma-separated, e.g. 1,2,2,4,4,4")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="one process of a torch.distributed group (torchrun's environment, or --coordinator)")
    p.add_argument("--coordinator", type=str, default=None, help="host:port of rank 0, without torchrun")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="default nccl on cuda, gloo on cpu; gloo puts several ranks on one card")
    return p


def _step_draws(seed: int, step: int, device) -> TorchDraws:
    return TorchDraws(torch.Generator(device).manual_seed(seed * 1_000_003 + step))


def _to_ncdhw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 0))).to(device)


def _save_sample(path: str, x: torch.Tensor, occ) -> None:
    """One sample (1, C, D, D, D) / (1, 1, 2D, 2D, 2D) → channels-last npz."""
    np.savez_compressed(path, grid=np.moveaxis(x[0].float().cpu().numpy(), 0, -1),
                        occgrid=occ[0, 0].float().cpu().numpy())


def main(argv=None) -> dict:
    """Run one mode; returns {"params", "start_step", "log", "seconds",
    "sampling_seconds", "samples", "snapshot_seconds", "snapshot_bytes"} as
    far as the mode fills them."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, PROG)
    if not args.multihost:
        return run(args, device, None)
    init_multihost(args.coordinator, args.num_processes, args.process_id, args.dist_backend, device.type)
    try:
        device = rank_device(device.type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return run(args, device, make_mesh(device_type=device.type))
    finally:
        dist.destroy_process_group()


def run(args, device, mesh) -> dict:
    """One mode of ``main`` on ``device``, data parallel over ``mesh``."""
    rank = dist.get_rank() if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    os.makedirs(args.workdir, exist_ok=True)
    feature_mask = occ_mask = None
    if args.mask_file:
        with np.load(args.mask_file) as z:  # masks mark valid sites; add the batch axis
            feature_mask = _to_ncdhw(z["feature_mask"], device)[None]
            occ_mask = torch.from_numpy(np.asarray(z["occ_mask"], np.float32)).to(device)[None, None]
    cfg = DiffusionTrainConfig(data_ch=args.data_ch, num_grad_acc_steps=args.grad_acc, lr=args.lr)
    unet_kw = dict(data_ch=args.data_ch, use_occ=True)
    if args.base_channels or args.ch_mult:
        mult = tuple(int(v) for v in (args.ch_mult or "1,2,2,4,4,4").split(","))
        n = len(mult)
        unet_kw.update(base_channels=args.base_channels or 128, ch_mult=mult,
                       down_block_types=("ResBlock",) * (n - 1) + ("AttnResBlock",),
                       up_block_types=("AttnResBlock",) + ("ResBlock",) * (n - 1))
    trainer = DiffusionTrainer(cfg, UNet3DConfig(**unet_kw), feature_mask, occ_mask, device, mesh)
    state = trainer.init_state(TorchDraws(torch.Generator(device).manual_seed(args.seed)).child("init"))
    ckpt_meta = os.path.join(args.workdir, "checkpoints-meta.pt")
    state = trainer.restore_checkpoint(ckpt_meta, state)
    out = {"params": n_params(state.model), "start_step": state.step, "log": [], "samples": []}
    say(f"{PROG}: {out['params']} parameters, step {state.step}, {trainer.unet_cfg.compute_dtype} "
        f"(TF32 off), remat {trainer.unet_cfg.remat}, device {device}"
        + (f", {trainer.world} ranks over {dist.get_backend()}" if mesh is not None else ""), flush=True)

    if args.mode == "train":
        if not args.data_glob:
            raise SystemExit(f"{PROG}: --data-glob is required for training")
        files = sorted(glob.glob(args.data_glob))
        if not files:
            raise SystemExit(f"{PROG}: no grids match {args.data_glob}")
        start = state.step
        if mesh is None:
            sampler = GridSampler(files, args.grad_acc, args.batch, seed=args.seed, start_step=start, device=device)
        else:
            sampler = DistributedGridSampler(files, args.grad_acc, args.batch, trainer.rank, trainer.world,
                                             seed=args.seed, start_step=start, device=device)
        for it in range(start, args.n_iters):
            t0 = time.time()
            batch = sampler()
            state, m = trainer.train_step(state, _step_draws(args.seed, it, device), batch)
            if it % args.log_freq == 0:
                out["log"].append({"step": it, "s": time.time() - t0, **m})
                say(f"step {it}: loss={m['loss']:.6f} grad_norm={m['grad_norm']:.4f} "
                    f"({time.time() - t0:.3f} s)", flush=True)
            if it % args.snapshot_freq == 0 and it > 0:
                t0 = time.time()
                trainer.save_checkpoint(ckpt_meta, state)
                out["snapshot_seconds"] = time.time() - t0
                out["snapshot_bytes"] = os.path.getsize(ckpt_meta)
                say(f"checkpoint at step {state.step}: {ckpt_meta} ({out['snapshot_bytes']} bytes, "
                    f"{out['snapshot_seconds']:.2f} s)", flush=True)
        return out

    state.ema.copy_to(state.model.parameters())  # sample with the EMA weights
    eps_fn = trainer.eps_fn(state.model)
    d = args.grid_size
    shape, occ_shape = (1, args.data_ch, d, d, d), (1, 1, 2 * d, 2 * d, 2 * d)
    draws = TorchDraws(torch.Generator(device).manual_seed(args.seed)).child(args.mode)
    t0 = mark = time.time()
    out["sampling_seconds"] = 0.0  # the samplers' own time, without writing the files

    def save(name):
        def fn(i, x, occ):
            nonlocal mark
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out["sampling_seconds"] += time.time() - mark
            path = os.path.join(args.workdir, name.format(i))
            if rank == 0:
                _save_sample(path, x, occ)
            out["samples"].append(path)
            say(f"{os.path.basename(path)} saved ({time.time() - t0:.2f} s)", flush=True)
            mark = time.time()
        return fn

    if args.mode == "cond_gen":
        if not args.cond_file:
            raise SystemExit(f"{PROG}: --cond-file is required for cond_gen")
        with np.load(args.cond_file) as z:
            condition = _to_ncdhw(np.asarray(z["grid"]).reshape(d, d, d, -1), device)[None]
            cond_mask = _to_ncdhw(np.asarray(z["cond_mask"]).reshape(d, d, d, -1), device)[None]
            occ_condition = occ_cond_mask = None
            if "occgrid" in z and "occ_cond_mask" in z:
                occ_condition = _to_ncdhw(np.asarray(z["occgrid"]).reshape(2 * d, 2 * d, 2 * d, 1), device)[None]
                occ_cond_mask = _to_ncdhw(np.asarray(z["occ_cond_mask"]).reshape(2 * d, 2 * d, 2 * d, 1),
                                          device)[None]
        for i in range(args.n_samples):
            x, x_occ = cond_gen(trainer.sde, eps_fn, condition, cond_mask, draws.child(f"sample{i}"), shape,
                                feature_mask=feature_mask, occ_shape=occ_shape, occ_mask=occ_mask,
                                occ_condition=occ_condition, occ_cond_mask=occ_cond_mask)
            save("cond_sample_{:04d}.npz")(i, x, x_occ)
    elif args.mode == "uncond_gen_interp":
        rows = uncond_gen_interp(trainer.sde, eps_fn, shape, occ_shape, draws, args.n_samples,
                                 n_interp=N_INTERP, n_steps=args.n_sampling_steps,
                                 feature_mask=feature_mask, occ_mask=occ_mask)
        for p, row in enumerate(rows):
            for j, (x, x_occ) in enumerate(row):
                save(f"interp_{p:04d}_{{:02d}}.npz")(j, x, x_occ)
    else:
        if args.sampling_method == "ddim":
            sampler = get_ddim_sampler(trainer.sde, eps_fn, shape, occ_shape, n_steps=args.n_sampling_steps,
                                       feature_mask=feature_mask, occ_mask=occ_mask)
        else:
            sampler = get_pc_sampler(trainer.sde, eps_fn, shape, occ_shape, feature_mask=feature_mask,
                                     occ_mask=occ_mask)
        uncond_gen(sampler, draws, args.n_samples, save("sample_{:04d}.npz"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["seconds"] = time.time() - t0
    return out


if __name__ == "__main__":
    main()
