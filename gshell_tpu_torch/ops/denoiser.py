"""SVGF-style bilateral denoiser (spatial only), gradients to the colour only.

PyTorch counterpart of ``gshell_tpu/ops/denoiser.py``.  Per pixel a
(2r+1)² bilateral filter with weights gaussian(distance) · ⟨n_tap, n_c⟩¹²⁸ ·
exp(−|Δz| / (dz·distance)).  :func:`bilateral_accumulate` is the stencil: on
a CUDA tensor the hand-written kernel ``csrc/bilateral.cu``, on a CPU tensor
the plain version beside it.  The colour has 3 channels, or 6 when the
renderer denoises diffuse and specular (which share their guides) in one
call; each channel sums its taps in the same order either way, so one
6-channel call equals two 3-channel calls bit for bit.
:class:`BilateralDenoiser` wraps it as an autograd function whose backward
runs the transposed stencil (``denom_from_tap=True``) — the weights are
constants, as in the reference's hand-written backward.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import kernels
from .math import safe_normalize

FLT_EPS = 1.1920929e-7


def _inv2var(sigma) -> float:
    """0.5 / max(σ², ε), as the TPU kernel computes it from its σ scalar."""
    s = float(sigma)
    return 0.5 / max(s * s, FLT_EPS)


def bilateral_plain(col, nrm, zdz, sigma, r: int, denom_from_tap: bool = False):
    """Plain PyTorch stencil (JAX ``_accumulate`` :67), one padded slice per
    tap offset, taps in row-major (fy, fx) order.  ``denom_from_tap`` takes
    dz at the tap instead of the centre (the transposed stencil).  Returns
    (acc_col (H, W, C), acc_w (H, W, 1))."""
    h, w, _ = col.shape
    f32 = dict(dtype=torch.float32, device=col.device)
    inv2var = torch.tensor(_inv2var(sigma), **f32)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, r, r, r, r))
    colp, nrmp, zdzp = pad(col), pad(nrm), pad(zdz)
    maskp = pad(torch.ones((h, w, 1), dtype=col.dtype, device=col.device))
    c_z, c_dz = zdz[..., 0:1], zdz[..., 1:2]
    acc_col = torch.zeros_like(col)
    acc_w = torch.zeros((h, w, 1), dtype=col.dtype, device=col.device)
    for fy in range(-r, r + 1):
        for fx in range(-r, r + 1):
            sl = lambda t: t[r + fy:r + fy + h, r + fx:r + fx + w]
            dist_sqr = float(fx * fx + fy * fy)
            w_xy = torch.exp(torch.tensor(-dist_sqr, **f32) * inv2var)
            tn = sl(nrmp)
            d = tn[..., 0:1] * nrm[..., 0:1] + tn[..., 1:2] * nrm[..., 1:2]
            d = d + tn[..., 2:3] * nrm[..., 2:3]
            w_n = torch.clamp(d, FLT_EPS, 1.0)
            for _ in range(7):  # ⟨n,n⟩¹²⁸ by squaring
                w_n = w_n * w_n
            t_zdz = sl(zdzp)
            dz = t_zdz[..., 1:2] if denom_from_tap else c_dz
            dist = torch.sqrt(torch.tensor(dist_sqr, **f32))
            w_d = torch.exp(-(torch.abs(t_zdz[..., 0:1] - c_z) / torch.clamp(dz * dist, min=FLT_EPS)))
            wgt = w_xy * w_n * w_d * sl(maskp)
            acc_col = acc_col + sl(colp) * wgt
            acc_w = acc_w + wgt
    return acc_col, acc_w


def bilateral_accumulate(col, nrm, zdz, sigma, r: int = 11, denom_from_tap: bool = False):
    """The (2r+1)² stencil.  CUDA tensors: the hand kernel; CPU tensors: the
    plain version.  col (H, W, C) with C in {3, 6}, nrm (H, W, 3), zdz
    (H, W, 2) f32; ``sigma`` a Python or 0-d tensor scalar.  Returns
    (acc_col (H, W, C), acc_w (H, W, 1))."""
    if col.device.type == "cpu":
        return bilateral_plain(col, nrm, zdz, sigma, r, denom_from_tap)
    h, w, c = col.shape
    dev = col.device
    if c not in (3, 6):
        raise ValueError(f"col: {c} channels, expected 3 or 6")
    kernels.require(col, "col", torch.float32, (h, w, c), dev)
    kernels.require(nrm, "nrm", torch.float32, (h, w, 3), dev)
    kernels.require(zdz, "zdz", torch.float32, (h, w, 2), dev)
    acc_col = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    acc_w = torch.empty((h, w, 1), dtype=torch.float32, device=dev)
    err = kernels.lib().gs_bilateral(
        ctypes.c_void_p(col.data_ptr()), ctypes.c_void_p(nrm.data_ptr()),
        ctypes.c_void_p(zdz.data_ptr()), ctypes.c_void_p(acc_col.data_ptr()),
        ctypes.c_void_p(acc_w.data_ptr()), h, w, c, int(r), _inv2var(sigma),
        int(bool(denom_from_tap)), ctypes.c_void_p(kernels.stream_ptr(col)),
    )
    kernels.check(err, "bilateral_accumulate")
    return acc_col, acc_w


class BilateralDenoiser(torch.autograd.Function):
    """acc_col / max(acc_w, 1e-4) on normalized normals; gradient to ``col``
    only (JAX custom VJP ``bilateral_denoiser`` :236)."""

    @staticmethod
    def forward(ctx, col, nrm, zdz, sigma, max_radius):
        nrm = safe_normalize(nrm).contiguous()
        zdz = zdz.contiguous()
        acc_col, acc_w = bilateral_accumulate(col.contiguous(), nrm, zdz, sigma, max_radius)
        ctx.save_for_backward(nrm, zdz, acc_w)
        ctx.sigma, ctx.r = sigma, max_radius
        return acc_col / torch.clamp(acc_w, min=1e-4)

    @staticmethod
    def backward(ctx, g):
        nrm, zdz, acc_w = ctx.saved_tensors
        gp = (g / torch.clamp(acc_w, min=1e-4)).contiguous()
        d_col, _ = bilateral_accumulate(gp, nrm, zdz, ctx.sigma, ctx.r, denom_from_tap=True)
        return d_col, None, None, None, None


def bilateral_denoiser(col, nrm, zdz, sigma, max_radius: int = 11):
    """Denoise ``col`` (H, W, 3 or 6) weighted by normals (H, W, 3) and (z, dz)
    (H, W, 2); ``sigma`` is a Python float (the spatial σ)."""
    return BilateralDenoiser.apply(col, nrm.detach(), zdz.detach(), float(sigma), max_radius)
