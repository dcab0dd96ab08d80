"""Core vector, camera and lat-long math (PyTorch twin of
``gshell_tpu/ops/math.py``).  Everything works on (..., C) tensors."""
from __future__ import annotations

import math

import numpy as np
import torch


def dot(x, y, keepdim: bool = True):
    """Row-wise dot product over the last axis."""
    return torch.sum(x * y, dim=-1, keepdim=keepdim)


def length(x, eps: float = 1e-12):
    """L2 norm over the last axis with the squared norm floored at ``eps``."""
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x, eps: float = 1e-12):
    return x / length(x, eps)


def abs_tie_up(x):
    """|x| whose derivative at 0 is +1, as ``jnp.abs``'s (``torch.abs`` gives
    0).  The two material taps of a fresh hash grid often round to the same
    value, so the choice moves the material gradients."""
    return torch.where(x >= 0, x, -x)


def sqrt_nonneg(x):
    """sqrt(max(x, 0)) whose derivative is 0 where x <= 0.  The forward
    equals ``jnp.sqrt(jnp.maximum(0, x))`` bit for bit; JAX's derivative is
    infinite at 0 and NaN below it (0 · ∞), which made every GGX-VNDF sample
    on the rim of the disk poison the gradient of everything upstream.  A
    deliberate difference from the JAX package (ROADMAP C)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def reflect(x, n):
    return 2 * dot(x, n) * n - x


def luminance(c):
    w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=c.dtype, device=c.device)
    return torch.sum(c * w, dim=-1, keepdim=True)


def build_orthonormal_basis(n):
    """Branchless ONB (Frisvad) from a normalized normal; ``t × b = n``."""
    sign = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t0 = torch.cat(
        [1.0 + sign * n[..., 0:1] * n[..., 0:1] * a, sign * b, -sign * n[..., 0:1]], dim=-1
    )
    t1 = torch.cat([b, sign + n[..., 1:2] * n[..., 1:2] * a, -n[..., 1:2]], dim=-1)
    return t0, t1


def cosine_sample(n, u, v):
    """Cosine-weighted hemisphere sample around ``n`` → (direction, pdf)."""
    n = safe_normalize(n)
    dx, dy = build_orthonormal_basis(n)
    phi = 2.0 * math.pi * u
    costheta = torch.sqrt(torch.clamp(v, 0.0, 1.0))
    sintheta = torch.sqrt(torch.clamp(1.0 - v, 0.0, 1.0))
    x = torch.cos(phi) * sintheta
    y = torch.sin(phi) * sintheta
    pdf = torch.clamp(costheta / math.pi, min=1e-6)
    vec = dx * x[..., None] + dy * y[..., None] + n * costheta[..., None]
    return safe_normalize(vec), pdf


def rgb_to_srgb(f):
    """Linear → sRGB on the first 3 channels; alpha passes through."""
    def conv(x):
        return torch.where(
            x <= 0.0031308, x * 12.92,
            1.055 * torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) - 0.055,
        )
    if f.shape[-1] == 4:
        return torch.cat([conv(f[..., :3]), f[..., 3:]], dim=-1)
    return conv(f)


def srgb_to_rgb(f):
    """sRGB → linear on the first 3 channels; alpha passes through."""
    def conv(x):
        return torch.where(
            x <= 0.04045, x / 12.92, torch.pow((torch.clamp(x, min=0.04045) + 0.055) / 1.055, 2.4),
        )
    if f.shape[-1] == 4:
        return torch.cat([conv(f[..., :3]), f[..., 3:]], dim=-1)
    return conv(f)


def avg_pool_nhwc(x, size: int):
    """Average pool (N, H, W, C) by an integer factor."""
    if size == 1:
        return x
    n, h, w, c = x.shape
    return x.reshape(n, h // size, size, w // size, size, c).mean(dim=(2, 4))


def _linear_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) weights of ``jax.image.resize``'s triangle kernel with
    antialiasing: half-pixel sample positions, the kernel widened by the
    shrink factor when downsampling, each column normalised, samples
    outside the input zeroed."""
    inv = torch.tensor(n_in / n_out, dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]) / torch.clamp(inv, min=1.0)
    wts = torch.clamp(1.0 - x, min=0.0)
    total = wts.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    wts = torch.where(total.abs() > eps, wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0).to(device)


def scale_img_nhwc(x, size, method: str = "nearest"):
    """Resize (N, H, W, C) to (H, W) = ``size`` as ``jax.image.resize``:
    ``nearest``, or ``linear`` / ``bilinear`` (half-pixel, edges clamped
    when growing, a widened triangle filter when shrinking)."""
    n, h, w, c = x.shape
    out_h, out_w = int(size[0]), int(size[1])
    if method == "nearest":
        for dim, (m, k) in ((1, (h, out_h)), (2, (w, out_w))):
            if m != k:
                idx = torch.floor((torch.arange(k, dtype=torch.float32) + 0.5) * m / k).long()
                x = x.index_select(dim, idx.to(x.device))
        return x
    if method not in ("linear", "bilinear"):
        raise ValueError(f"resize method {method!r}: nearest, linear or bilinear")
    if h != out_h:
        x = torch.einsum("nhwc,hH->nHwc", x, _linear_weights(h, out_h, x.device).to(x.dtype))
    if w != out_w:
        x = torch.einsum("nhwc,wW->nhWc", x, _linear_weights(w, out_w, x.device).to(x.dtype))
    return x


def pixel_grid(width: int, height: int, device=None):
    """(H, W, 2) pixel-centre uv grid in [0, 1]."""
    y = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    x = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def cube_face_dirs(uv):
    """Outward directions (6, …, 3) of cube-face coordinates ``uv`` (…, 2) in
    [-1, 1], OpenGL face order +x, −x, +y, −y, +z, −z (unnormalised)."""
    gx, gy = uv[..., 0], uv[..., 1]
    one = torch.ones_like(gx)
    return torch.stack([
        torch.stack([one, -gy, -gx], -1), torch.stack([-one, -gy, gx], -1),
        torch.stack([gx, one, gy], -1), torch.stack([gx, -one, -gy], -1),
        torch.stack([gx, -gy, one], -1), torch.stack([-gx, -gy, -one], -1),
    ], dim=0)


def latlong_to_cubemap(latlong, res: int):
    """Nearest-texel lookup of a lat-long map (H, W, C) into a (6, res, res, C)
    cubemap."""
    dirs = safe_normalize(cube_face_dirs(pixel_grid(res, res, latlong.device) * 2.0 - 1.0))
    tuv = dir_to_latlong_uv(dirs)
    h, w = latlong.shape[:2]
    px = torch.clamp((tuv[..., 0] * w).to(torch.int64), 0, w - 1)
    py = torch.clamp((tuv[..., 1] * h).to(torch.int64), 0, h - 1)
    return latlong[py, px]


def mse_to_psnr(mse):
    """PSNR in dB of a mean squared error on [0, 1] images."""
    return -10.0 * torch.log10(torch.clamp(torch.as_tensor(mse), min=1e-10))


def dir_to_latlong_uv(d):
    """Direction → lat-long uv (``u = atan2(x, -z)/2π + 0.5``); the clip
    stays 1e-6 inside ±1 so the arccos gradient stays finite."""
    u = torch.atan2(d[..., 0:1], -d[..., 2:3]) / (2.0 * math.pi) + 0.5
    v = torch.arccos(torch.clamp(d[..., 1:2], -1.0 + 1e-6, 1.0 - 1e-6)) / math.pi
    return torch.cat([u, v], dim=-1)


def latlong_uv_to_dir(uv):
    phi = (uv[..., 0:1] * 2.0 - 1.0) * math.pi
    theta = uv[..., 1:2] * math.pi
    sinphi, cosphi = torch.sin(phi), torch.cos(phi)
    sintheta, costheta = torch.sin(theta), torch.cos(theta)
    return torch.cat([sintheta * sinphi, costheta, -sintheta * cosphi], dim=-1)


def perspective(fovy: float, aspect: float = 1.0, n: float = 0.1, f: float = 1000.0,
                device=None):
    """OpenGL perspective projection (y row negated, as the reference)."""
    y = math.tan(fovy / 2.0)
    return torch.tensor(
        [
            [1.0 / (y * aspect), 0, 0, 0],
            [0, -1.0 / y, 0, 0],
            [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
            [0, 0, -1, 0],
        ],
        dtype=torch.float32, device=device,
    )


def lookat(eye, at, up):
    """View matrix (reference ``util.lookAt``)."""
    eye, at, up = (torch.as_tensor(v, dtype=torch.float32) for v in (eye, at, up))
    w = safe_normalize(eye - at)
    u = safe_normalize(torch.linalg.cross(up, w))
    v = safe_normalize(torch.linalg.cross(w, u))
    rot = torch.stack([u, v, w], dim=0)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ eye
    return m


def rotate_x(a: float, device=None):
    s, c = math.sin(a), math.cos(a)
    return torch.tensor([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                        dtype=torch.float32, device=device)


def xfm_points(points, matrix):
    """(N, 3) points × (4, 4) matrix → homogeneous (N, 4)."""
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.einsum("...ij,...nj->...ni", matrix, pts_h)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x, scale: float):
    """Identity forward; gradient × ``scale`` (the reference's encoder hook)."""
    return _ScaleGrad.apply(x, scale)
