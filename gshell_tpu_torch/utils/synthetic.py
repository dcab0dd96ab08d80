"""Synthetic inputs: meshes that hold the stage-B kernel to its rule, and
stand-ins for fitted G-Shell states for the diffusion pipeline.

:func:`crowded_tile_mesh` crowds one 16×16 screen tile with far more
(triangle, tile) pairs than one stage-B sub-segment takes, so the kernel
must merge several sub-segments, and plants exact depth ties across them:
duplicated triangles (equal z, the least id must win) and a +0.0 sheet
whose duplicate at -0.0 comes last (the rule treats ±0 as equal, so the
+0.0 sheet's lower ids must win).  Vertices sit on a quarter-pixel grid and
depths on eighths, so every edge value and depth numerator is exact in
float32: any two implementations of the rule, with or without FMA
contraction, give the same ids.

:func:`open_ellipsoid_state` stands in for a fitted garment where no baked
data set is at hand: a direct-SDF ellipsoid cut open by a tilted mSDF plane.

:func:`vary_material` gives a neural material a kd that varies smoothly
across a surface (a fresh one is nearly constant), so that a texture bake's
round trip shows whether the atlas is the right way round.
"""
from __future__ import annotations

import numpy as np
import torch

TILE = 16


def crowded_tile_mesh(res: int, n_small: int = 600, n_dup: int = 80, seed: int = 0):
    """(v_clip (3F, 4) f32, faces (F, 3) int64) on the CPU for a res×res
    image; tile (1, 1) holds ``n_small + n_dup + 4`` pairs plus the big
    triangles'.  Ids, in order: the +0.0 sheet (2), ``n_small`` small
    triangles at z in {1/8 .. 7/8}, four big triangles at z = 0.5 over the
    whole image, ``n_dup`` duplicates of small triangles, the -0.0 sheet."""
    assert res % TILE == 0 and res >= 2 * TILE
    rng = np.random.default_rng(seed)
    lo, hi = TILE + 0.25, 2 * TILE - 0.25

    def quad(x0, y0, x1, y1):  # two positively oriented triangles
        return [[(x0, y0), (x1, y0), (x0, y1)], [(x1, y0), (x1, y1), (x0, y1)]]

    sheet = np.array(quad(TILE + 1.0, TILE + 1.0, TILE + 9.0, 2 * TILE - 2.0), np.float32)
    small = np.round(rng.uniform(lo, hi, size=(n_small, 3, 2)) * 4.0) / 4.0
    flip = rng.random(n_small) < 0.5  # both orientations
    small[flip] = small[flip][:, ::-1]
    small_z = rng.integers(1, 8, size=n_small) / 8.0
    big = np.array(quad(0.0, 0.0, float(res), float(res)) + quad(1.0, 0.0, float(res), float(res) - 1.0),
                   np.float32)
    dup = rng.choice(n_small, size=n_dup, replace=False)

    xy = np.concatenate([sheet, small, big, small[dup], sheet]).astype(np.float32)
    z = np.concatenate([
        np.zeros(2), small_z, np.full(4, 0.5), small_z[dup], np.full(2, -0.0),
    ]).astype(np.float32)
    f = xy.shape[0]
    ndc = xy / np.float32(res) * np.float32(2.0) - np.float32(1.0)  # exact: dyadic
    v_clip = np.concatenate([
        ndc.reshape(-1, 2), np.repeat(z, 3)[:, None], np.ones((3 * f, 1), np.float32),
    ], axis=1).astype(np.float32)
    faces = np.arange(3 * f, dtype=np.int64).reshape(f, 3)
    return torch.from_numpy(v_clip), torch.from_numpy(faces)


def open_ellipsoid_state(res: int, seed: int, scale: float = 1.4) -> dict:
    """``{"params_geo": {"deform", "sdf", "msdf"}}`` (CPU tensors) on the
    res-``res`` lattice of the scale-``scale`` box, from numpy seeded with
    ``seed``: an ellipsoid SDF with radii in [0.25, 0.4], positive inside
    (the sign ``GenerativeCodec.decode`` assumes when it pads the cropped
    outer plane with 0), cut open by a tilted mSDF plane through it
    (positive mSDF keeps the surface), and deform uniform in ±0.3."""
    rng = np.random.default_rng(seed)
    n = res + 1
    axis = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    axis = axis - axis.mean()
    p = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3) * np.float32(scale)
    radii = rng.uniform(0.25, 0.4, size=3)
    sdf = (1.0 - np.linalg.norm(p / radii, axis=-1)) * radii.min()
    normal = np.array([0.0, 1.0, 0.0]) + rng.uniform(-0.4, 0.4, size=3)
    normal /= np.linalg.norm(normal)
    msdf = p @ normal + rng.uniform(-0.1, 0.1) * radii.min()
    deform = rng.uniform(-0.3, 0.3, size=(n ** 3, 3))
    return {"params_geo": {k: torch.from_numpy(v.astype(np.float32))
                           for k, v in (("deform", deform), ("sdf", sdf), ("msdf", msdf))}}


def vary_material(params_mat: dict, seed: int, levels: int = 4, scale: float = 1.0) -> dict:
    """A copy of the neural material ``params_mat`` whose ``levels`` coarsest
    hash-grid tables are drawn uniform in ±``scale`` from ``seed`` (the init
    draws ±1e-4); the finer levels and the MLP are kept.  The coarsest
    levels have 16 to ~50 cells across the material's box (the default
    grid), so kd varies over a garment without aliasing in a 1024² bake."""
    tables = params_mat["tables"].detach().clone()
    gen = torch.Generator().manual_seed(seed)
    fresh = (torch.rand(tables[:levels].shape, generator=gen) * 2.0 - 1.0) * scale
    tables[:levels] = fresh.to(tables.device)
    return {**params_mat, "tables": tables}
