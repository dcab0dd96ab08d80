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
also holds the per-cube weights and their Adam moments).
``--bake-texture RES`` ends the run by UV-unwrapping the final mesh (on the
host) and baking the material into RES² atlases on the run's device:
``texture_kd.png``, ``texture_ks.png``, ``mesh_textured.obj`` and
``baked.mtl``, which ``load_obj(with_attrs=True)``, ``load_mtl`` and
``merge_materials`` read back.  The config's ``use_sdf_mlp`` /
``use_msdf_mlp`` choose an SDF MLP (pretrained to a sphere for
``sdf_mlp_pretrain_steps``) or a direct per-vertex SDF that starts as that
sphere, and a direct mSDF or an mSDF MLP; the snapshot holds whichever
(``sdf`` or ``sdf_net``, ``msdf`` or ``msdf_net``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .data.datasets import DatasetDeepFashion, DatasetMesh, DatasetNeRF
from .ops.math import rgb_to_srgb
from .ops.mesh_ops import orient_faces
from .ops.uv_unwrap import unwrap
from .render.light import update_pdf
from .render.material import load_mtl, merge_materials, texture_material
from .render.mesh import load_obj, save_obj, unit_size
from .render.render import render_mesh, render_uv
from .train.reconstruct import load_state, save_state
from .train.setup import (add_bool, gt_light_material, kernel_launches, launches_since,
                          reconstructor_from_flags, resolve_device)
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
                   help="after training, UV-unwrap the mesh and bake kd/ks atlases at RES² "
                        "(texture_kd.png, texture_ks.png, mesh_textured.obj, baked.mtl)")
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


def chart_count(uv_idx: np.ndarray, n_uv: int) -> int:
    """Connected components of the UV faces (charts share UV vertices only
    inside themselves), by min-label propagation with pointer jumping."""
    lab = np.arange(n_uv)
    while True:
        new = lab.copy()
        np.minimum.at(new, uv_idx.reshape(-1), np.repeat(lab[uv_idx].min(axis=1), 3))
        new = new[new]
        if np.array_equal(new, lab):
            return int(np.unique(lab[uv_idx.reshape(-1)]).shape[0])
        lab = new


@torch.no_grad()
def bake_texture(rec, state, out_dir: str, res: int) -> dict:
    """The final mesh without invalid or degenerate faces and with its
    vertices compacted, its faces wound consistently (``orient_faces``) and
    UV-unwrapped on the host (``unwrap``), its material baked into res² kd /
    ks atlases by :func:`render_uv` on the run's device; writes
    ``texture_kd.png``, ``texture_ks.png``, ``mesh_textured.obj`` and
    ``baked.mtl`` (JAX's names and formats).  JAX unwraps the extractor's
    faces as they are wound, which cuts its atlas into charts of a few faces
    (ROADMAP C).  → the bake's record: seconds of the orientation and unwrap
    and of ``render_uv``, charts, UV vertices, faces, the atlas's covered
    fraction and whether every texel is finite; a mesh without faces writes
    nothing (``faces`` 0)."""
    mesh = rec.geo.get_mesh(state.params_geo)
    f = mesh.faces[mesh.face_valid]
    f = f[~((f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 0] == f[:, 2]))]
    if f.shape[0] == 0:
        print(f"bake skipped: the final mesh has no faces; nothing written to {out_dir}", flush=True)
        return {"faces": 0}
    used, inv = torch.unique(f.reshape(-1), return_inverse=True)
    verts, dev = mesh.verts[used], mesh.verts.device
    t0 = time.time()
    faces_np = orient_faces(inv.reshape(-1, 3).cpu().numpy())
    uvs, uv_idx = unwrap(verts.cpu().numpy(), faces_np)
    t_unwrap = time.time() - t0
    faces = torch.as_tensor(faces_np, device=dev)
    _sync(dev)
    t0 = time.time()
    mask, kd, ks = render_uv(torch.as_tensor(uvs, device=dev), torch.as_tensor(uv_idx, device=dev).long(),
                             verts, faces, (res, res), state.params_mat, rec.mat_cfg)
    _sync(dev)
    t_bake = time.time() - t0
    save_image(os.path.join(out_dir, "texture_kd.png"), kd.cpu().numpy())
    save_image(os.path.join(out_dir, "texture_ks.png"), ks.cpu().numpy())
    save_obj(os.path.join(out_dir, "mesh_textured.obj"), verts, faces, uvs=uvs, uv_idx=uv_idx, mtl_name="baked")
    with open(os.path.join(out_dir, "baked.mtl"), "w") as m:
        m.write("newmtl baked\nbsdf pbr\nmap_Kd texture_kd.png\nmap_Ks texture_ks.png\n")
    out = {"unwrap_seconds": t_unwrap, "render_uv_seconds": t_bake, "charts": chart_count(uv_idx, len(uvs)),
           "uv_verts": int(len(uvs)), "faces": int(faces.shape[0]), "covered": float(mask.mean()),
           "finite": bool(torch.isfinite(kd).all() and torch.isfinite(ks).all())}
    print(f"baked {res}x{res} kd/ks atlases -> {out_dir}: {out['faces']} faces, {out['charts']} charts, "
          f"{out['uv_verts']} UV vertices, {100 * out['covered']:.1f} % covered; unwrap {t_unwrap:.2f} s, "
          f"render_uv {t_bake:.2f} s", flush=True)
    return out


def load_baked(out_dir: str, device="cpu"):
    """The asset :func:`bake_texture` wrote in ``out_dir``, loaded back:
    ``mesh_textured.obj`` (``load_obj(with_attrs=True)``), ``baked.mtl``
    (``load_mtl``) and its PNGs through ``merge_materials`` → (mesh, UVs
    (T, 2), UV faces (F, 3), :class:`TextureMaterial`), ready for
    ``render_mesh(..., material, ..., v_tex=UVs, t_tex_idx=UV faces)``."""
    mesh, attrs = load_obj(os.path.join(out_dir, "mesh_textured.obj"), with_attrs=True, device=device)
    mats = load_mtl(os.path.join(out_dir, "baked.mtl"))
    uber, uvs, tfaces = merge_materials(mats, mesh.v_tex.cpu().numpy(), attrs["t_tex_idx"], attrs["m_face_idx"],
                                        device=device)
    return (mesh, torch.as_tensor(uvs, device=device), torch.as_tensor(tfaces, device=device).long(),
            texture_material(uber))


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
    the ground truth's build time, the kernel launches of each phase and,
    with ``--bake-texture``, the bake's record."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.log_interval < 1:
        parser.error("--log-interval must be >= 1")
    device = resolve_device(args.device, PROG)
    flags = load_flags(args.config, iter=args.iter, batch=args.batch, out_dir=args.out_dir,
                       trainset_path=args.trainset_path, ref_mesh=args.ref_mesh,
                       n_samples=args.n_samples, use_flexicubes=args.flexicubes or None)
    if args.bake_texture < 0:
        parser.error("--bake-texture must be >= 0")
    if args.testset_path:
        parser.error("--testset-path is not used in training; evaluate with "
                     "python -m gshell_tpu_torch.eval_reconstruction --testset-path")
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
            if device.type == "cuda":
                m["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30  # so far in the process
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
    if args.bake_texture:
        summary["bake"] = bake_texture(rec, state, flags.out_dir, args.bake_texture)
    print("done.", flush=True)
    return summary


if __name__ == "__main__":
    main()
