"""Posed-image datasets for inverse rendering (PyTorch twin of
``gshell_tpu/data/datasets.py``).

* :class:`DatasetDeepFashion` / :class:`DatasetDeepFashionTestset` — IDR-style
  ``cameras_sphere.npz`` with PNG views (and a mask directory);
* :class:`DatasetNeRF` — NeRF-synthetic ``transforms_*.json``;
* :class:`DatasetMesh` — ground truth rendered from a reference mesh through
  the port's own renderer.

Views are held as torch tensors on the dataset's device; ``batch`` /
``iterate`` draw view indices and random backgrounds from numpy's
``default_rng``, so for one seed they equal the JAX package's bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import math as gmath
from ..ops.mesh_ops import auto_normals, sample_surface
from ..ops.shade import make_shadow_field, splat_lattice
from ..render.render import render_mesh
from ..utils.image import load_image
from ..utils.rng import TorchDraws

# Seed of the draw source that renders DatasetMesh ground truth when the
# caller gives none: the shadow splat draws first, so a training set and a
# held-out set (other camera seed) share one GT shadow field.
GT_RENDER_SEED = 191


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3×4 projection into intrinsics and camera-to-world pose
    (RQ decomposition by a flipped QR)."""
    M = P[:3, :3]
    rev = np.flipud(np.eye(3))
    q, r = np.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    sign = np.diag(np.sign(np.diag(K)))  # positive diagonal of K
    K = K @ sign
    R = sign @ R
    t = np.linalg.lstsq(-M, P[:3, 3], rcond=None)[0]  # camera center

    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = t
    return intrinsics, pose


def _srgb_to_rgb_np(f):
    return np.where(f <= 0.04045, f / 12.92, ((np.clip(f, 0.04045, None) + 0.055) / 1.055) ** 2.4)


def _load_img(path: str) -> np.ndarray:
    """(H, W, 4) float32: linear RGB from the 8-bit sRGB file, alpha 1 if
    the file has none."""
    img = load_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if not path.lower().endswith(".hdr"):
        img[..., 0:3] = _srgb_to_rgb_np(img[..., 0:3])
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    return img


def resize_image(img: np.ndarray, res) -> np.ndarray:
    """Bilinear resize of (H, W, C) to ``res`` with the triangle filter
    widened when shrinking (``jax.image.resize(..., "linear")``'s
    antialiasing; plain bilinear would alias at a downscale)."""
    if img.shape[:2] == tuple(res):
        return img
    x = torch.as_tensor(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=tuple(res), mode="bilinear", align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).numpy()


class PosedImageDataset:
    """Base: (mvp, campos, img) per view on ``device``; iterates random
    batches."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.mvp: torch.Tensor = None  # (N, 4, 4)
        self.campos: torch.Tensor = None  # (N, 3)
        self.imgs: torch.Tensor = None  # (N, H, W, 4) premultiplied alpha
        self.resolution = None

    def __len__(self):
        return self.mvp.shape[0]

    def _store(self, mvps, camposs, imgs, resolution):
        as_t = lambda a: torch.as_tensor(np.stack(a).astype(np.float32), device=self.device)
        self.mvp, self.campos, self.imgs = as_t(mvps), as_t(camposs), as_t(imgs)
        self.resolution = tuple(resolution)

    def batch(self, idx, background: str = "random", rng: np.random.Generator | None = None) -> dict:
        """A training batch: the chosen background mixed into the
        premultiplied-alpha reference image."""
        rng = rng or np.random.default_rng()
        idx = np.asarray(idx)
        sel = torch.as_tensor(idx, device=self.device)
        img = self.imgs[sel]
        h, w = img.shape[1:3]
        if background == "random":
            bg = rng.random((len(idx), h, w, 3), dtype=np.float32)
        elif background == "white":
            bg = np.ones((len(idx), h, w, 3), dtype=np.float32)
        else:
            bg = np.zeros((len(idx), h, w, 3), dtype=np.float32)
        bg = torch.as_tensor(bg, device=self.device)
        return {
            "mvp": self.mvp[sel],
            "campos": self.campos[sel],
            "img": torch.cat([img[..., 0:3] + bg * (1.0 - img[..., 3:]), img[..., 3:]], -1),
            "background": bg,
        }

    def iterate(self, batch_size: int, steps: int, background="random", seed=0,
                rng: np.random.Generator | None = None) -> Iterator[dict]:
        """``steps`` random batches from ``default_rng(seed)``, or from
        ``rng`` (a stream a resumed run restores) when given."""
        rng = np.random.default_rng(seed) if rng is None else rng
        n = len(self)
        for _ in range(steps):
            idx = rng.integers(0, n, size=batch_size)
            yield self.batch(idx, background, rng)


def _premultiplied(img: np.ndarray) -> np.ndarray:
    img[..., 0:3] *= img[..., 3:]
    img[..., 3] = np.sign(img[..., 3])
    return img


class DatasetDeepFashion(PosedImageDataset):
    """IDR-style DeepFashion3D views: ``cameras_sphere.npz`` and
    ``{i:03d}.png``; fovy 60°, premultiplied alpha, y/z flip of the pose."""

    def __init__(self, base_dir: str, train_res=(512, 512), cam_near_far=(0.1, 1000.0),
                 n_images: int = 72, device="cpu"):
        super().__init__(device)
        cams = np.load(os.path.join(base_dir, "cameras_sphere.npz"))
        proj = gmath.perspective(np.deg2rad(60.0), train_res[1] / train_res[0], *cam_near_far).numpy()
        flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
        mvps, camposs, imgs = [], [], []
        for i in range(n_images):
            world_mat = cams[f"world_mat_{i}"].astype(np.float32)
            scale_mat = cams[f"scale_mat_{i}"].astype(np.float32)
            _, pose = load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
            mv = flip @ np.linalg.inv(pose)
            camposs.append(np.linalg.inv(mv)[:3, 3])
            mvps.append(proj @ mv)
            imgs.append(_premultiplied(resize_image(_load_img(os.path.join(base_dir, f"{i:03d}.png")),
                                                    train_res)))
        self._store(mvps, camposs, imgs, train_res)


class DatasetNeRF(PosedImageDataset):
    """NeRF-synthetic views (``transforms_train.json``)."""

    def __init__(self, cfg_path: str, train_res=(512, 512), cam_near_far=(0.1, 1000.0),
                 examples: Optional[int] = None, device="cpu"):
        super().__init__(device)
        base_dir = os.path.dirname(cfg_path)
        with open(cfg_path) as f:
            cfg = json.load(f)
        fovx = cfg["camera_angle_x"]
        frames = cfg["frames"][:examples] if examples else cfg["frames"]
        rx = gmath.rotate_x(-np.pi / 2).numpy()
        aspect = train_res[1] / train_res[0]
        fovy = 2.0 * np.arctan(np.tan(fovx / 2.0) / aspect)  # fov_x → fov_y for the aspect
        proj = gmath.perspective(fovy, aspect, *cam_near_far).numpy()
        mvps, camposs, imgs = [], [], []
        for frame in frames:
            img = resize_image(_load_img(os.path.join(base_dir, frame["file_path"] + ".png")), train_res)
            imgs.append(_premultiplied(img))
            mv = np.linalg.inv(rx @ np.asarray(frame["transform_matrix"], np.float32))
            camposs.append(np.linalg.inv(mv)[:3, 3])
            mvps.append(proj @ mv)
        self._store(mvps, camposs, imgs, train_res)


class DatasetDeepFashionTestset(DatasetDeepFashion):
    """DeepFashion test split with its masks in ``mask_dir``."""

    def __init__(self, base_dir: str, mask_dir: str, train_res=(512, 512), **kw):
        super().__init__(base_dir, train_res=train_res, **kw)
        for i in range(self.imgs.shape[0]):
            m = load_image(os.path.join(mask_dir, f"{i:03d}.png"))
            m = m[..., None] if m.ndim == 2 else m[..., :1]
            m = torch.as_tensor(np.sign(resize_image(m, train_res)), device=self.device)
            self.imgs[i, ..., 3:] = m
            self.imgs[i, ..., 0:3] *= m


class DatasetMesh(PosedImageDataset):
    """Ground truth rendered from a reference mesh: ``n_views`` random
    cameras on a sphere of ``cam_radius`` (from ``default_rng(seed)``), each
    rendered by :func:`render_mesh` on the exact full-image path
    (``shade_budget=None``, ``jitter_tap_frac=1.0``).

    ``shadows``: render through the swept shadow field of the mesh's own
    occupancy, a splat of 2^17 surface samples over its bounds padded by
    5 % of the extent, on a ``shadow_grid_res``³ lattice; ``splat_coverage``
    holds the splat's coverage (:func:`~..ops.shade.splat_lattice`).

    ``draws``: the draw source of the render, ``splat/...`` first, then
    ``view{i}/...`` per view; by default a generator on the mesh's device
    seeded with :data:`GT_RENDER_SEED`."""

    def __init__(self, mesh, light, mat_params, mat_cfg, flags, n_views: int = 64,
                 cam_radius: float = 3.0, fovy_deg: float = 45.0, seed: int = 0,
                 layers: int = 1, shadows: bool = False, shadow_grid_res: int = 65, draws=None):
        dev = mesh.v_pos.device
        super().__init__(dev)
        if layers > 1:
            raise NotImplementedError("second-layer ground truth (layers > 1) is not yet ported "
                                      "(ROADMAP D.5)")
        flags = flags._replace(shade_budget=None, jitter_tap_frac=1.0)
        draws = draws if draws is not None else TorchDraws(torch.Generator(dev).manual_seed(GT_RENDER_SEED))
        v_pos, t_idx = mesh.v_pos, mesh.t_pos_idx
        v_nrm = mesh.v_nrm if mesh.v_nrm is not None else auto_normals(v_pos, t_idx)
        h, w = flags.resolution

        visibility, shadow_scale = None, 0.0
        self.splat_coverage = None
        if shadows:
            with torch.no_grad():
                pts = sample_surface(draws.child("splat"), v_pos, t_idx, 1 << 17)
                lo, hi = v_pos.min(dim=0).values, v_pos.max(dim=0).values
                pad = 0.05 * torch.max(hi - lo)
                aabb_min, aabb_size = lo - pad, (hi - lo) + 2 * pad
                occ, coverage = splat_lattice(pts, aabb_min, aabb_size, shadow_grid_res)
            visibility = make_shadow_field(occ, aabb_min.cpu().numpy(), aabb_size.cpu().numpy())
            self.splat_coverage = {k: v.item() for k, v in coverage.items()}
            shadow_scale = 1.0

        rng = np.random.default_rng(seed)
        proj = gmath.perspective(np.deg2rad(fovy_deg), w / h, 0.1, 1000.0, device=dev)
        at, up = torch.zeros(3, device=dev), torch.tensor([0.0, 1.0, 0.0], device=dev)
        mvps, camposs, imgs = [], [], []
        for i in range(n_views):
            v = rng.normal(size=3)
            v = v / np.linalg.norm(v)
            eye = torch.as_tensor(v * cam_radius, dtype=torch.float32, device=dev)
            mvp = proj @ gmath.lookat(eye, at, up)
            with torch.no_grad():
                buf = render_mesh(draws.child(f"view{i}"), v_pos, t_idx, v_nrm, None, mat_params,
                                  mat_cfg, mvp, eye, light, flags, shadow_scale=shadow_scale,
                                  visibility=visibility)
            img = buf["shaded"]
            imgs.append(torch.cat([img[..., 0:3] * img[..., 3:], img[..., 3:]], -1))
            mvps.append(mvp)
            camposs.append(eye)
        self.mvp, self.campos, self.imgs = torch.stack(mvps), torch.stack(camposs), torch.stack(imgs)
        self.resolution = tuple(flags.resolution)
