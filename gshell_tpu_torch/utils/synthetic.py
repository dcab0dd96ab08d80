"""Synthetic meshes that hold the stage-B kernel to its rule.

:func:`crowded_tile_mesh` crowds one 16×16 screen tile with far more
(triangle, tile) pairs than one stage-B sub-segment takes, so the kernel
must merge several sub-segments, and plants exact depth ties across them:
duplicated triangles (equal z, the least id must win) and a +0.0 sheet
whose duplicate at -0.0 comes last (the rule treats ±0 as equal, so the
+0.0 sheet's lower ids must win).  Vertices sit on a quarter-pixel grid and
depths on eighths, so every edge value and depth numerator is exact in
float32: any two implementations of the rule, with or without FMA
contraction, give the same ids.
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
