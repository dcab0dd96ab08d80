"""Cubemap prefilters for split-sum image-based lighting (PyTorch twin of
``gshell_tpu/ops/cubemap.py``): cosine- and GGX-weighted integrals of an
environment cubemap, each one dense (N, N) weighting of all N = 6·res²
texels and a matrix product.  Library functions: no entry point calls
them (the training path samples the light by Monte Carlo, ``ops/shade.py``)."""
from __future__ import annotations

import math

import torch

from .math import cube_face_dirs, safe_normalize


def _face_coords(res: int, device=None):
    t = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res * 2.0 - 1.0
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    return gx, gy


def cube_dirs(res: int, device=None):
    """(6, res, res, 3) outward direction of every texel, OpenGL face order
    +x, −x, +y, −y, +z, −z."""
    gx, gy = _face_coords(res, device)
    return safe_normalize(cube_face_dirs(torch.stack([gx, gy], -1)))


def texel_solid_angles(res: int, device=None):
    """(6, res, res) solid angle of each texel."""
    gx, gy = _face_coords(res, device)
    r2 = gx * gx + gy * gy + 1.0
    return (4.0 / (res * res) / (r2 * torch.sqrt(r2))).expand(6, res, res)


def diffuse_cubemap(cubemap):
    """Cosine-weighted irradiance: (6, H, H, 3) → the same shape."""
    res = cubemap.shape[1]
    dirs = cube_dirs(res, cubemap.device).reshape(-1, 3)
    sa = texel_solid_angles(res, cubemap.device).reshape(-1)
    cosw = torch.clamp(dirs @ dirs.T, min=0.0) * sa[None, :]
    out = (cosw @ cubemap.reshape(-1, 3)) / torch.clamp(cosw.sum(-1, keepdim=True), min=1e-8)
    return out.reshape(cubemap.shape)


def _ndf_ggx(alpha_sqr, cos_theta):
    d = (cos_theta * alpha_sqr - cos_theta) * cos_theta + 1.0
    return alpha_sqr / (d * d * math.pi)


def specular_cubemap(cubemap, roughness: float, cutoff: float = 0.99):
    """GGX-filtered radiance for one roughness (N = V = R), integrated over
    the whole sphere: (6, H, H, 4), rgb premultiplied by the total weight,
    which is in channel 3."""
    res = cubemap.shape[1]
    dirs = cube_dirs(res, cubemap.device).reshape(-1, 3)
    sa = texel_solid_angles(res, cubemap.device).reshape(-1)
    alpha = max(roughness * roughness, 1e-3)
    cosw = dirs @ dirs.T
    w = _ndf_ggx(alpha * alpha, torch.clamp(cosw, 0.0, 1.0)) * torch.clamp(cosw, min=0.0) * sa[None, :]
    out = torch.cat([w @ cubemap.reshape(-1, 3), w.sum(-1, keepdim=True)], dim=-1)
    return out.reshape(cubemap.shape[0], res, res, 4)


def specular_mip_chain(cubemap, min_roughness: float = 0.08, max_roughness: float = 0.5) -> list:
    """Roughness chain: level k filtered at lerp(min, max, k / (n − 1)) of
    the cubemap box-halved k times, normalised by its weight."""
    res = cubemap.shape[1]
    levels = max(int(math.log2(res)) - 1, 2)
    out, base = [], cubemap
    for k in range(levels):
        r = min_roughness + (max_roughness - min_roughness) * k / max(levels - 1, 1)
        filt = specular_cubemap(base, r)
        out.append(filt[..., :3] / torch.clamp(filt[..., 3:], min=1e-8))
        if min(base.shape[1], base.shape[2]) > 1:
            base = base.reshape(6, base.shape[1] // 2, 2, base.shape[2] // 2, 2, 3).mean(dim=(2, 4))
    return out
