"""Reconstruction training CLI of the port (twin of ``train_gshell.py``).

Usage:
  python -m gshell_tpu_torch.utils.synthetic_gt skirt out/skirt.obj
  python -m gshell_tpu_torch.train_gshell --config configs/synthetic_skirt_512_shadowed.json \\
      --ref-mesh out/skirt.obj --out-dir out/skirt --resume
  python -m gshell_tpu_torch.train_gshell --config configs/deepfashion_mc_256.json \\
      --trainset-path /data/deepfashion3d/30 --out-dir out/df30
  python -m gshell_tpu_torch.train_gshell --config configs/deepfashion_mc_80.json \\
      --ref-mesh out/skirt.obj --out-dir out/skirt_flexi

Runs on ``--device cuda`` (the default) through the hand kernels; without a
card it exits non-zero unless given ``--device cpu``.  Every ``save_interval``
iterations it writes ``state.pt`` (parameters, Adam states, schedules, the
draw and data streams), ``mesh_{it:06d}.obj`` and, unless
``--snapshot-images 0``, ``img_{it:06d}.png``; at the end the final mesh,
state and ``probe.hdr``.  ``--resume`` continues from ``state.pt`` with the
same draw and data streams, so a run split in two equals one run straight
through.  ``use_flexicubes`` in the config, or ``--flexicubes``, trains
G-Shell on FlexiCubes over the config's ``voxel_grid`` (its ``state.pt``
also holds the per-cube weights and their Adam moments).  Settings the port cannot honour yet exit non-zero and name their
ROADMAP item.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data.datasets import DatasetDeepFashion, DatasetMesh, DatasetNeRF
from .ops.math import rgb_to_srgb
from .render.light import update_pdf
from .render.mesh import load_obj, save_obj, unit_size
from .render.render import render_mesh
from .train.reconstruct import load_state, save_state
from .train.setup import (add_bool, gt_light_material, kernel_launches, launches_since,
                          reconstructor_from_flags, resolve_device, unported_options)
from .utils.config import load_flags
from .utils.image import save_image
from .utils.rng import TorchDraws

PROG = "gshell_tpu_torch.train_gshell"
GT_VIEWS = 64  # views of the synthetic (--ref-mesh FILE.obj) ground truth


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=PROG, description="G-Shell reconstruction (PyTorch port)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("-i", "--iter", type=int, default=None)
    p.add_argument("-b", "--batch", type=int, default=None)
    p.add_argument("-o", "--out-dir", dest="out_dir", type=str, default="out/run")
    p.add_argument("--trainset-path", dest="trainset_path", type=str, default=None)
    p.add_argument("--testset-path", dest="testset_path", type=str, default=None)
    p.add_argument("--ref-mesh", dest="ref_mesh", type=str, default=None)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    add_bool(p, "--flexicubes", help="FlexiCubes geometry on the config's voxel_grid (as use_flexicubes)")
    p.add_argument("--bake-texture", type=int, default=0, metavar="RES",
                   help="UV-unwrap and bake kd/ks atlases (not yet ported: exits)")
    add_bool(p, "--snapshot-images", default=True,
             help="render a [render | reference] image at each save_interval (default 1)")
    add_bool(p, "--resume", help="continue from OUT_DIR/state.pt if it exists")
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_dataset(flags, rec, device):
    if flags.trainset_path:
        return DatasetDeepFashion(flags.trainset_path, train_res=tuple(flags.train_res), device=device)
    if flags.ref_mesh and os.path.isdir(flags.ref_mesh):
        return DatasetNeRF(os.path.join(flags.ref_mesh, "transforms_train.json"),
                           train_res=tuple(flags.train_res), device=device)
    if flags.ref_mesh and flags.ref_mesh.endswith(".obj"):
        gt_mesh = unit_size(load_obj(flags.ref_mesh, device=device))
        light, mat = gt_light_material(rec.mat_cfg, device)
        return DatasetMesh(gt_mesh, light, mat, rec.mat_cfg, rec.flags, n_views=GT_VIEWS,
                           layers=flags.layers, shadows=flags.gt_shadows)
    raise SystemExit(f"{PROG}: need --trainset-path (DeepFashion), --ref-mesh DIR (NeRF) or "
                     "--ref-mesh FILE.obj (synthetic)")


def save_mesh(rec, state, out_dir, it) -> int:
    mesh = rec.geo.get_mesh(state.params_geo)
    return save_obj(os.path.join(out_dir, f"mesh_{it:06d}.obj"), mesh.verts, mesh.faces, mesh.face_valid)


@torch.no_grad()
def save_snapshot_image(rec, state, target, out_dir, it):
    """[render | reference] of the batch's first view, sRGB."""
    mesh = rec.geo.get_mesh(state.params_geo)
    draws = TorchDraws(torch.Generator(rec.device).manual_seed(it))
    buf = render_mesh(draws, mesh.verts, mesh.faces, mesh.v_nrm, mesh.msdf, state.params_mat,
                      rec.mat_cfg, target["mvp"][0], target["campos"][0],
                      update_pdf(state.light_base.detach()), rec.flags,
                      background=target["background"][0], shadow_scale=0.0)
    srgb = lambda x: torch.clamp(rgb_to_srgb(x[..., 0:3]), 0.0, 1.0).cpu().numpy()
    save_image(os.path.join(out_dir, f"img_{it:06d}.png"),
               np.concatenate([srgb(buf["shaded"]), srgb(target["img"][0])], axis=1))


def main(argv=None) -> dict:
    """Train; returns a summary: the first iteration, the logged metrics,
    the ground truth's build time and the kernel launches of each phase."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.log_interval < 1:
        parser.error("--log-interval must be >= 1")
    device = resolve_device(args.device, PROG)
    flags = load_flags(args.config, iter=args.iter, batch=args.batch, out_dir=args.out_dir,
                       trainset_path=args.trainset_path, ref_mesh=args.ref_mesh,
                       n_samples=args.n_samples, use_flexicubes=args.flexicubes or None)
    problems = unported_options(flags)
    if args.bake_texture:
        problems.append("--bake-texture (texture bake, ROADMAP D.5)")
    if args.testset_path:
        parser.error("--testset-path is not used in training; evaluate with "
                     "python -m gshell_tpu_torch.eval_reconstruction --testset-path")
    if problems:
        raise SystemExit(f"{PROG}: not yet ported: " + "; ".join(problems))
    os.makedirs(flags.out_dir, exist_ok=True)
    rec = reconstructor_from_flags(flags, device)

    c0, t0 = kernel_launches(), time.time()
    ds = make_dataset(flags, rec, device)
    _sync(device)
    summary = {"gt_seconds": time.time() - t0, "gt_views": len(ds), "launches": {"dataset": launches_since(c0)}}
    if getattr(ds, "splat_coverage", None):
        summary["gt_splat"] = ds.splat_coverage
    print(f"dataset: {len(ds)} views in {summary['gt_seconds']:.2f} s", flush=True)

    draws = TorchDraws(torch.Generator(device).manual_seed(0))
    data_rng = np.random.default_rng(0)
    state_path = os.path.join(flags.out_dir, "state.pt")
    start_it = 0
    if args.resume and os.path.exists(state_path):
        state, extra = load_state(rec, state_path, draws)
        data_rng.bit_generator.state = extra["data_rng"]
        start_it = state.step
        print(f"resumed from {state_path} at iter {start_it}", flush=True)
    else:
        state = rec.init_state(draws.child("init"), pretrain_steps=flags.sdf_mlp_pretrain_steps)
    summary.update(start_it=start_it, log=[])

    def snapshot():
        save_state(state, draws, state_path, data_rng=data_rng.bit_generator.state)

    c0, t_hist, t0 = kernel_launches(), [], time.time()
    batches = ds.iterate(flags.batch, max(flags.iter - start_it, 0), background="random", rng=data_rng)
    for it_off, target in enumerate(batches):
        it = start_it + it_off
        m = rec.train_step(state, draws.child(f"step{it}"), target)
        if it % args.log_interval == 0:
            m = {k: float(v) for k, v in m.items()}  # waits for the step
            t_hist.append((time.time() - t0) / args.log_interval)
            t0 = time.time()
            rem = (flags.iter - it) * np.mean(t_hist[-10:])
            cover = (f", splat_cells={int(m['splat_cells'])}, splat_spc={m['splat_samples_per_cell']:.2f}, "
                     f"splat_singletons={int(m['splat_singletons'])}") if "splat_cells" in m else ""
            print(f"iter={it:5d}, img_loss={m['img_loss']:.6f}, reg_loss={m['reg_loss']:.6f}, "
                  f"nactive={int(m.get('n_valid_tets', m.get('n_surf_cubes')))}, n_faces={int(m['n_faces'])}{cover}, "
                  f"time={t_hist[-1] * 1000:.1f} ms, rem={rem / 60:.1f} min", flush=True)
            summary["log"].append({"it": it, "s": t_hist[-1], **m})
        if flags.save_interval and it > 0 and it % flags.save_interval == 0:
            snapshot()  # state first: the dumps are diagnostics
            save_mesh(rec, state, flags.out_dir, it)
            if args.snapshot_images:
                save_snapshot_image(rec, state, target, flags.out_dir, it)
    _sync(device)
    summary["launches"]["train"] = launches_since(c0)

    summary["final_faces"] = save_mesh(rec, state, flags.out_dir, flags.iter)
    snapshot()
    save_image(os.path.join(flags.out_dir, "probe.hdr"), state.light_base.detach().cpu().numpy())
    print("done.", flush=True)
    return summary


if __name__ == "__main__":
    main()
