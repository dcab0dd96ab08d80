"""Core vector, camera and lat-long math (PyTorch twin of
``gshell_tpu/ops/math.py``).  Everything works on (..., C) tensors."""
from __future__ import annotations

import math

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


def luminance(c):
    w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=c.dtype, device=c.device)
    return torch.sum(c * w, dim=-1, keepdim=True)


def cross(a, b):
    """3-vector cross product over the last axis, the operands broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


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


def avg_pool_nhwc(x, size: int):
    """Average pool (N, H, W, C) by an integer factor."""
    if size == 1:
        return x
    n, h, w, c = x.shape
    return x.reshape(n, h // size, size, w // size, size, c).mean(dim=(2, 4))


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
