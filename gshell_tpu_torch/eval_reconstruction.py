"""Evaluate a fitted reconstruction of the port: held-out PSNR and the
Chamfer-L2 distance to a ground-truth mesh (twin of ``eval_reconstruction.py``).

Usage:
  python -m gshell_tpu_torch.eval_reconstruction --state out/skirt/state.pt \\
      --config configs/synthetic_skirt_512_shadowed.json \\
      --synthetic-ref-mesh out/skirt.obj --gt-mesh out/skirt.obj --gt-unit-size \\
      --out-dir out/skirt/validate

Reads the port's ``state.pt``.  ``--synthetic-ref-mesh`` renders 16 held-out
views (camera seed 777) with the training run's ground-truth light and
material; ``--testset-path`` reads a DeepFashion test split.  When the run
trained against shadowed ground truth (``gt_shadows``), the fitted model is
rendered under the shadow field of its own cut-mesh splat, as in training.
``metrics.txt`` (and with ``--dump-images`` the ``val_*.png`` triptychs) go
to ``--out-dir``.  A FlexiCubes state (one with per-cube weights) is
evaluated on its FlexiCubes mesh, whatever the config's ``use_flexicubes``,
and a state's fields (a direct ``sdf`` or an ``sdf_net``, a direct
``msdf`` or an ``msdf_net``) are read as the state holds them.
Runs on ``--device cuda`` unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

import torch

from .data.datasets import DatasetDeepFashion, DatasetDeepFashionTestset, DatasetMesh
from .ops.shade import make_shadow_field
from .render.light import update_pdf
from .render.mesh import load_obj, unit_size
from .render.render import render_mesh
from .train.reconstruct import TrainConfig, load_state
from .train.setup import (add_bool, gt_light_material, kernel_launches, launches_since,
                          reconstructor_from_flags, resolve_device)
from .train.validate import chamfer_distance, validate
from .utils.config import load_flags
from .utils.rng import TorchDraws

PROG = "gshell_tpu_torch.eval_reconstruction"
SPLAT_SEED, RENDER_SEED, CHAMFER_SEED, HELD_OUT_SEED = 191, 0, 1, 777
CHAMFER_SAMPLES = 50000 // 4096 * 4096  # surface samples per mesh (49,152)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=PROG, description="held-out PSNR and Chamfer (PyTorch port)")
    p.add_argument("--state", type=str, required=True)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--testset-path", type=str, default=None)
    p.add_argument("--gt-mesh", type=str, default=None)
    p.add_argument("--synthetic-ref-mesh", type=str, default=None,
                   help="held-out synthetic views: the training run's ground truth, other cameras")
    p.add_argument("--out-dir", type=str, default="out/validate")
    p.add_argument("--n-views", type=int, default=None)
    p.add_argument("--spp", type=int, default=None,
                   help="n_samples of both the ground-truth and the evaluated render (>= 1; "
                   "default: the config's)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    add_bool(p, "--dump-images", help="write per-view [render | reference | 5x diff] triptychs")
    add_bool(p, "--gt-unit-size",
             help="unit_size-normalize --gt-mesh before the Chamfer (synthetic runs train in that frame)")
    return p


def main(argv=None) -> dict:
    """Evaluate; returns {"mse", "psnr", "per_view", "chamfer", "launches"} as
    far as the options ask."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.spp is not None and args.spp < 1:
        p.error(f"--spp must be >= 1 (got {args.spp})")
    if args.n_views is not None and args.n_views < 1:
        p.error(f"--n-views must be >= 1 (got {args.n_views})")
    device = resolve_device(args.device, PROG)
    flags = load_flags(args.config)
    # the state says which geometry and fields it fits: FlexiCubes keeps
    # per-cube weights, an MLP field its ``*_net`` (FlexiCubes keeps a direct
    # mSDF under use_msdf_mlp, so its flag stays the config's)
    record = torch.load(args.state, map_location="cpu", weights_only=True, mmap=True)
    pg = record["params_geo"]
    flags.use_flexicubes = "cube_weights" in pg
    flags.use_sdf_mlp = "sdf_net" in pg
    if not flags.use_flexicubes:
        flags.use_msdf_mlp = "msdf_net" in pg
    rec = reconstructor_from_flags(flags, device, n_samples=args.spp)
    # every pixel shaded; spp 1 and denoising before modulation whatever the
    # config says, as JAX's eval builds its flags
    rflags = rec.flags._replace(shade_budget=None, spp=1, denoiser_demodulate=True)
    state, _ = load_state(rec, args.state)
    light = update_pdf(state.light_base.detach())
    params_mat = {"tables": state.params_mat["tables"].detach(),
                  "mlp": [w.detach() for w in state.params_mat["mlp"]]}
    mesh = rec.geo.get_mesh(state.params_geo)
    print(f"state {args.state}: step {state.step}, {int(mesh.n_faces)} faces", flush=True)

    visibility, shadow_scale = None, 0.0
    if flags.gt_shadows:
        occ, amin, asz, _ = rec.geo.splat_occupancy(TorchDraws(torch.Generator(device).manual_seed(SPLAT_SEED)),
                                                    mesh.verts, mesh.faces, mesh.face_valid)
        visibility, shadow_scale = make_shadow_field(occ, amin, asz, ko=TrainConfig().shadow_ko), 1.0
    draws = TorchDraws(torch.Generator(device).manual_seed(RENDER_SEED))

    def render_batch(batch):
        views = [render_mesh(draws.child(f"view{b}"), mesh.verts, mesh.faces, mesh.v_nrm, mesh.msdf,
                             params_mat, rec.mat_cfg, batch["mvp"][b], batch["campos"][b], light, rflags,
                             background=batch["background"][b], visibility=visibility,
                             shadow_scale=shadow_scale)
                 for b in range(batch["mvp"].shape[0])]
        return {k: torch.stack([v[k] for v in views]) for k, t in views[0].items()
                if isinstance(t, torch.Tensor) and t.ndim == 3}

    results = {"launches": {}}

    def run(name, ds, n_views):
        c0 = kernel_launches()
        metrics = validate(render_batch, ds, out_dir=args.out_dir, n_views=n_views,
                           dump_images=args.dump_images)
        results["launches"][name] = launches_since(c0)
        results.update(metrics)
        return metrics

    if args.synthetic_ref_mesh:
        gt_mesh = unit_size(load_obj(args.synthetic_ref_mesh, device=device))
        gt_light, gt_mat = gt_light_material(rec.mat_cfg, device)
        n = args.n_views or 16
        c0 = kernel_launches()
        ds = DatasetMesh(gt_mesh, gt_light, gt_mat, rec.mat_cfg, rflags, n_views=n, seed=HELD_OUT_SEED,
                         shadows=flags.gt_shadows)
        results["launches"]["ground_truth"] = launches_since(c0)
        m = run("synthetic", ds, n)
        print(f"held-out synthetic PSNR: {m['psnr']:.3f}  MSE: {m['mse']:.6f}", flush=True)

    if args.testset_path:
        res = tuple(flags.train_res)
        masks = os.path.join(args.testset_path, "masks")
        ds = (DatasetDeepFashionTestset(args.testset_path, masks, train_res=res, device=device)
              if os.path.isdir(masks) else DatasetDeepFashion(args.testset_path, train_res=res, device=device))
        m = run("testset", ds, args.n_views)
        print(f"PSNR: {m['psnr']:.3f}  MSE: {m['mse']:.6f}", flush=True)

    if args.gt_mesh:
        gt = load_obj(args.gt_mesh, device=device)
        if args.gt_unit_size or args.synthetic_ref_mesh:
            gt = unit_size(gt)
        cd = chamfer_distance(TorchDraws(torch.Generator(device).manual_seed(CHAMFER_SEED)),
                              mesh.verts, mesh.faces, gt.v_pos, gt.t_pos_idx, mask1=mesh.face_valid,
                              n_samples=CHAMFER_SAMPLES, chunk=min(4096, CHAMFER_SAMPLES))
        results["chamfer"] = float(cd)
        print(f"Chamfer-L2: {results['chamfer']:.6f}", flush=True)
    return results


if __name__ == "__main__":
    main()
