"""Decode G-MeshDiffusion samples into open meshes and write OBJs (twin of
``eval_gmeshdiffusion.py``): load (grid, occgrid) pairs, quantize the SDF
signs, run the grid-driven G-Shell marching (``GenerativeCodec.decode``)
and smooth with an umbrella Laplacian (in place of the reference's
pymeshlab pass).

Usage:
  python -m gshell_tpu_torch.eval_gmeshdiffusion --samples 'out/diffusion/sample_*.npz' \\
      --grid-res 64 --out-dir out/meshes

Samples are channels-last ``.npz`` files, as either package writes them.
Runs on ``--device cuda`` unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from .geometry.generative_decode import BakedGrids, GenerativeCodec
from .geometry.gshell_tets import GShellTets
from .geometry.tet_grid import build_tet_grid
from .render.mesh import save_obj
from .train.setup import resolve_device

PROG = "gshell_tpu_torch.eval_gmeshdiffusion"


def laplacian_smooth(verts: np.ndarray, faces: np.ndarray, iterations: int = 3, lam: float = 0.5):
    """Umbrella Laplacian smoothing (replaces the pymeshlab post-pass,
    ref :192-201)."""
    n = verts.shape[0]
    nbr_sum = np.zeros_like(verts)
    nbr_cnt = np.zeros((n, 1))
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    for _ in range(iterations):
        nbr_sum[:] = 0
        nbr_cnt[:] = 0
        np.add.at(nbr_sum, edges[:, 0], verts[edges[:, 1]])
        np.add.at(nbr_sum, edges[:, 1], verts[edges[:, 0]])
        np.add.at(nbr_cnt, edges[:, 0], 1)
        np.add.at(nbr_cnt, edges[:, 1], 1)
        avg = nbr_sum / np.maximum(nbr_cnt, 1)
        verts = verts + lam * (avg - verts) * (nbr_cnt > 0)
    return verts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=PROG, description="decode diffusion samples into meshes (PyTorch port)")
    p.add_argument("--samples", type=str, required=True)
    p.add_argument("--grid-res", type=int, default=64)
    p.add_argument("--out-dir", type=str, default="out/meshes")
    p.add_argument("--scale", type=float, default=1.4)
    p.add_argument("--smooth-iters", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Decode every sample; returns {sample name: face count}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, PROG)
    grid = build_tet_grid(args.grid_res, build_topology=False)
    codec = GenerativeCodec(GShellTets(grid, device))
    d1, d2 = codec.d1, codec.d2
    base_verts = grid.verts * args.scale
    max_disp = 1.0 / args.grid_res * args.scale / 2.1
    vc = codec.vert_coords.cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    out = {}
    for path in sorted(glob.glob(args.samples)):
        with np.load(path) as z:
            feat = np.asarray(z["grid"], np.float32)
            occ = np.asarray(z["occgrid"], np.float32)
        # samples are masked (2R)³ / (4R)³ volumes; pad or crop to the site space
        fg = np.zeros((d1, d1, d1, feat.shape[-1] if feat.ndim == 4 else 4), np.float32)
        s = min(d1, feat.shape[0])
        fg[:s, :s, :s] = feat[:s, :s, :s]
        og = np.zeros((d2, d2, d2), np.float32)
        so = min(d2, occ.shape[0])
        og[:so, :so, :so] = occ[:so, :so, :so]
        fg[vc[:, 0], vc[:, 1], vc[:, 2], 0] = np.sign(fg[vc[:, 0], vc[:, 1], vc[:, 2], 0])
        deform = fg[vc[:, 0], vc[:, 1], vc[:, 2], 1:4]
        pos = base_verts + max_disp * np.clip(deform, -1, 1)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        fg_c, og_c = t(fg[:d1 - 1, :d1 - 1, :d1 - 1]), t(og[:d2 - 1, :d2 - 1, :d2 - 1])
        mesh = codec.decode(t(pos), BakedGrids(fg_c, og_c, torch.ones_like(fg_c), torch.ones_like(og_c)))
        v = mesh.verts.cpu().numpy()
        f = mesh.faces.cpu().numpy()[mesh.face_valid.cpu().numpy()]
        if args.smooth_iters > 0 and f.shape[0] > 0:
            v = laplacian_smooth(v, f, iterations=args.smooth_iters)
        name = os.path.splitext(os.path.basename(path))[0]
        save_obj(os.path.join(args.out_dir, f"{name}.obj"), v, f)
        out[name] = int(f.shape[0])
        print(f"{name}: {f.shape[0]} faces", flush=True)
    return out


if __name__ == "__main__":
    main()
