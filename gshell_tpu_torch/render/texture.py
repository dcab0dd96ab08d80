"""2-D textures with mip chains and differentiable trilinear sampling
(PyTorch twin of ``gshell_tpu/render/texture.py``).

A :class:`Texture2D` keeps every mip level as its own tensor, as JAX does:
``sample`` reads the stored levels, so a trainable texture's levels each
get their own gradient.  Texel row 0 is v = 0 (no flip)."""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..ops.math import avg_pool_nhwc, srgb_to_rgb


class Texture2D(NamedTuple):
    """``mips[0]`` is the base level (H, W, C); level k is (H/2^k, W/2^k, C)."""

    mips: tuple

    @property
    def base(self):
        return self.mips[0]


def create_trainable(init, res: Sequence[int] | None = None, auto_mipmaps: bool = True) -> Texture2D:
    """A texture from an (H, W, C) image, or from a (C,) colour broadcast to
    ``res``; with ``auto_mipmaps`` its average-pooled chain down to 1×1."""
    init = torch.as_tensor(init, dtype=torch.float32)
    if init.ndim == 1 and res is not None:
        init = init.expand(res[0], res[1], init.shape[0]).clone()
    return build_mips(init) if auto_mipmaps else Texture2D(mips=(init,))


def build_mips(base) -> Texture2D:
    """Average-pool mip chain down to 1×1."""
    mips = [base]
    while min(mips[-1].shape[0], mips[-1].shape[1]) > 1:
        mips.append(avg_pool_nhwc(mips[-1][None], 2)[0])
    return Texture2D(mips=tuple(mips))


def _bilinear(tex, uv):
    """Bilinear fetch with clamped borders; uv ∈ [0, 1]², tex (H, W, C)."""
    h, w, _ = tex.shape
    x = torch.clamp(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    return (tex[y0, x0] * (1 - tx) * (1 - ty) + tex[y0, x1] * tx * (1 - ty)
            + tex[y1, x0] * (1 - tx) * ty + tex[y1, x1] * tx * ty)


def sample(tex: Texture2D, uv, uv_deriv=None):
    """Trilinear mip sampling.  ``uv_deriv`` (…, 4) = (du/dx, du/dy, dv/dx,
    dv/dy) in uv units per pixel; None → the base level only.  The level is
    log2 of the larger screen footprint, clipped to the chain; each pixel
    blends its two levels, selected by mask."""
    if uv_deriv is None or len(tex.mips) == 1:
        return _bilinear(tex.mips[0], uv)
    h, w, _ = tex.mips[0].shape
    fx = torch.sqrt((uv_deriv[..., 0] * w) ** 2 + (uv_deriv[..., 2] * h) ** 2)
    fy = torch.sqrt((uv_deriv[..., 1] * w) ** 2 + (uv_deriv[..., 3] * h) ** 2)
    rho = torch.clamp(torch.maximum(fx, fy), min=1e-8)
    n = len(tex.mips)
    lod = torch.clamp(torch.log2(rho), 0.0, n - 1.0)
    lo = torch.floor(lod).long()
    t = (lod - lo)[..., None]
    levels = [_bilinear(m, uv) for m in tex.mips]
    out = torch.zeros(uv.shape[:-1] + (tex.mips[0].shape[-1],), dtype=levels[0].dtype, device=uv.device)
    for k in range(n - 1):
        out = torch.where((lo == k)[..., None], levels[k] * (1 - t) + levels[k + 1] * t, out)
    return torch.where((lo >= n - 1)[..., None], levels[-1], out)


def clamp(tex: Texture2D, min_val=0.0, max_val=1.0) -> Texture2D:
    return Texture2D(mips=tuple(torch.clamp(m, min_val, max_val) for m in tex.mips))


def normalize(tex: Texture2D) -> Texture2D:
    """Re-normalise a normal map stored in [0, 1]."""
    def nrm(m):
        v = m * 2.0 - 1.0
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-6)
        return v * 0.5 + 0.5

    return Texture2D(mips=tuple(nrm(m) for m in tex.mips))


def srgb_to_linear(tex: Texture2D) -> Texture2D:
    return Texture2D(mips=tuple(srgb_to_rgb(m) for m in tex.mips))
