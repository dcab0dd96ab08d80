"""Environment light with importance-sampling tables (PyTorch twin of
``gshell_tpu/render/light.py``).  ``base`` is trainable; pdf and CDFs are
derived without gradient."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.math import dir_to_latlong_uv, latlong_uv_to_dir, scale_img_nhwc

_ONE_MINUS = 0.99999994  # largest float32 below 1


class EnvLight(NamedTuple):
    base: torch.Tensor  # (H, W, 3) HDR lat-long radiance
    pdf: torch.Tensor  # (H, W) normalized selection pdf
    rows: torch.Tensor  # (H,) row CDF
    cols: torch.Tensor  # (H, W) per-row column CDF


def update_pdf(base) -> EnvLight:
    h = base.shape[0]
    with torch.no_grad():
        y = (torch.arange(h, dtype=base.dtype, device=base.device) + 0.5) / h
        pdf = torch.amax(base, dim=-1) * torch.sin(y * math.pi)[:, None]
        pdf = pdf / torch.clamp(torch.sum(pdf), min=1e-12)
        cols = torch.cumsum(pdf, dim=1)
        rows = torch.cumsum(cols[:, -1], dim=0)
        cols = cols / torch.where(cols[:, -1:] > 0, cols[:, -1:], 1.0)
        rows = rows / torch.where(rows[-1] > 0, rows[-1], 1.0)
    return EnvLight(base=base, pdf=pdf, rows=rows, cols=cols)


def create_trainable_env_rnd(draws, base_res: int = 512, scale: float = 0.5, bias: float = 0.25,
                             device=None) -> EnvLight:
    """Uniform-noise light ``U(0, 1)·scale + bias``; draws ``base``."""
    base = draws.uniform("base", (base_res, base_res, 3)).to(device) * scale + bias
    return update_pdf(base)


def _texel(uv, h: int, w: int):
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return y, x


def eval_light(light: EnvLight, dirs):
    """Nearest-texel radiance; differentiable w.r.t. ``light.base``."""
    h, w = light.base.shape[:2]
    y, x = _texel(dir_to_latlong_uv(dirs), h, w)
    return light.base[y, x]


def light_pdf(light: EnvLight, dirs):
    """Selection pdf of a direction (solid-angle measure)."""
    h, w = light.pdf.shape
    uv = dir_to_latlong_uv(dirs)
    y, x = _texel(uv, h, w)
    sin_t = torch.clamp(torch.sin(uv[..., 1:2] * math.pi), min=1e-4)
    weight = (h * w) / (2.0 * math.pi * math.pi * sin_t)
    return light.pdf[y, x][..., None] * weight


def _sample_cdf(cdf, x):
    """Inverse CDF of a shared 1-D CDF: (index, residual), 'right' semantics."""
    n = cdf.shape[-1]
    x = torch.clamp(x, max=_ONE_MINUS)
    idx = torch.clamp(torch.searchsorted(cdf, x, right=True), 0, n - 1)
    hi = cdf[idx]
    lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
    pdf = torch.clamp(hi - lo, min=1e-12)
    return idx, torch.clamp((x - lo) / pdf, max=_ONE_MINUS)


def _sample_cdf_2d(cols, y, x):
    """Per-row inverse CDF by a branchless binary search with 2-D gathers
    (never materializes the (P, W) row gather)."""
    n = cols.shape[-1]
    x = torch.clamp(x, max=_ONE_MINUS)
    idx = torch.zeros_like(y)
    step = 1 << (n - 1).bit_length()
    while step > 0:
        cand = idx + step
        ok = (cand <= n) & (cols[y, torch.clamp(cand, max=n) - 1] <= x)
        idx = torch.where(ok, cand, idx)
        step >>= 1
    idx = torch.clamp(idx, 0, n - 1)
    hi = cols[y, idx]
    lo = torch.where(idx > 0, cols[y, torch.clamp(idx - 1, min=0)], 0.0)
    pdf = torch.clamp(hi - lo, min=1e-12)
    return idx, torch.clamp((x - lo) / pdf, max=_ONE_MINUS)


def sample_light(light: EnvLight, u, v):
    """Importance-sample directions: u, v (...,) uniforms → (dirs (..., 3),
    pdf (..., 1))."""
    h, w = light.pdf.shape
    shp = u.shape
    y, ry = _sample_cdf(light.rows, v.reshape(-1))
    x, rx = _sample_cdf_2d(light.cols, y, u.reshape(-1))
    uv = torch.stack([(x.to(u.dtype) + rx) / w, (y.to(v.dtype) + ry) / h], dim=-1)
    dirs = latlong_uv_to_dir(uv).reshape(*shp, 3)
    return dirs, light_pdf(light, dirs)


def generate_image(light: EnvLight, res):
    """The base map resized to ``res`` = (H, W) as ``jax.image.resize``'s
    ``linear`` does (a widened triangle filter when it shrinks)."""
    return scale_img_nhwc(light.base[None], res, method="linear")[0]
