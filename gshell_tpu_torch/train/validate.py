"""Validation metrics: held-out-view PSNR / MSE and the Chamfer distance
between meshes (PyTorch twin of ``gshell_tpu/train/validate.py``).

``validate`` writes ``metrics.txt`` (one row per view, then the averages) in
the JAX package's format."""
from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..ops.math import mse_to_psnr, rgb_to_srgb
from ..ops.mesh_ops import sample_surface
from ..utils.image import save_image


def validate_view(buffers: dict, ref_img):
    """(MSE, PSNR) on tone-mapped sRGB clipped to [0, 1]."""
    opt = torch.clamp(rgb_to_srgb(buffers["shaded"][..., 0:3]), 0.0, 1.0)
    ref = torch.clamp(rgb_to_srgb(ref_img[..., 0:3]), 0.0, 1.0)
    mse = torch.mean((opt - ref) ** 2)
    return mse, mse_to_psnr(mse)


def validate(render_fn: Callable, dataset, out_dir: str | None = None, n_views: int | None = None,
             dump_images: bool = False) -> dict:
    """Render the first ``n_views`` views of ``dataset`` (all by default) on
    a black background; ``render_fn(batch)`` returns buffers with a leading
    batch axis.  With ``out_dir`` writes ``metrics.txt``; ``dump_images``
    also writes ``val_{i:03d}.png``, [render | reference | 5×|diff|] in
    sRGB."""
    rows = []
    for i in range(n_views or len(dataset)):
        batch = dataset.batch(np.asarray([i]), background="black")
        with torch.no_grad():
            single = {k: v[0] for k, v in render_fn(batch).items()
                      if isinstance(v, torch.Tensor) and v.ndim >= 3}
            mse, psnr = validate_view(single, batch["img"][0])
            if dump_images and out_dir:
                os.makedirs(out_dir, exist_ok=True)
                srgb = lambda x: torch.clamp(rgb_to_srgb(x[..., 0:3]), 0.0, 1.0).cpu().numpy()
                opt, ref = srgb(single["shaded"]), srgb(batch["img"][0])
                diff = np.clip(5.0 * np.abs(opt - ref), 0, 1)
                save_image(os.path.join(out_dir, f"val_{i:03d}.png"), np.concatenate([opt, ref, diff], axis=1))
        rows.append((float(mse), float(psnr)))
    mses, psnrs = zip(*rows)
    avg = (float(np.mean(mses)), float(np.mean(psnrs)))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
            f.write("ID, MSE, PSNR\n")
            for i, (m, p) in enumerate(rows):
                f.write(f"{i}, {m:1.8f}, {p:2.3f}\n")
            f.write(f"AVERAGES: {avg[0]:1.4f}, {avg[1]:2.3f}\n")
    return {"mse": avg[0], "psnr": avg[1], "per_view": rows}


def _one_way(a, b, chunk: int):
    """Mean over ``a``'s first ⌊n/chunk⌋·chunk points of the squared
    distance to the nearest point of ``b``, ``chunk`` rows at a time."""
    n_chunks = a.shape[0] // chunk
    total = torch.zeros((), dtype=a.dtype, device=a.device)
    for c in range(n_chunks):
        sl = a[c * chunk:(c + 1) * chunk]
        d = (sl[:, None, 0] - b[None, :, 0]) ** 2
        d = d + (sl[:, None, 1] - b[None, :, 1]) ** 2
        d = d + (sl[:, None, 2] - b[None, :, 2]) ** 2
        total = total + d.min(dim=1).values.sum()
    return total / (n_chunks * chunk)


@torch.no_grad()
def chamfer_distance(draws, v1, f1, v2, f2, n_samples: int = 50000, mask1=None, mask2=None,
                     chunk: int = 4096):
    """Symmetric Chamfer-L2 between two triangle meshes from ``n_samples``
    area-weighted surface samples of each (draws ``a/...`` and ``b/...``);
    an exact nearest neighbour, ``chunk`` query points at a time."""
    p1 = sample_surface(draws.child("a"), v1, f1, n_samples, face_mask=mask1)
    p2 = sample_surface(draws.child("b"), v2, f2, n_samples, face_mask=mask2)
    return _one_way(p1, p2, chunk) + _one_way(p2, p1, chunk)
