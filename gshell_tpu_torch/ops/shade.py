"""Monte-Carlo environment shading with MIS, and the swept shadow field
(PyTorch twin of ``gshell_tpu/ops/shade.py``).

Per pixel, n² stratified sample pairs of light importance sampling (from a
per-step rotation of a shared pool of inverted light samples) and BSDF
importance sampling (cosine or GGX-VNDF), combined with the balance
heuristic; every sample is shadow-tested against a directional shadow field
swept from an occupancy lattice (the cut mesh's splat, or the negated
template SDF), or by marching the template SDF along the ray
(:class:`SdfVisibility`).  :class:`_MCAccumulate` keeps the sample loop's
memory O(pixels): its backward re-walks the samples and reuses the
visibilities saved by the forward.

On the card the walk is the hand-written kernel pair ``csrc/mc_shade.cu``
(:class:`_MCShade`): one thread a pixel row walks every sample in
registers, forward and in reverse, with the eager walk's arithmetic and
rounding points, the shadow field's lookup or the SDF march included; it
takes f32 pixel rows, pool and marcher grid and an f32 or bf16 light, and
:func:`env_shade` raises on anything else there.  On the CPU the eager walk
runs, which is also the plain version the kernel is held to.

Counters: ``mc_shade_launches`` counts the kernel pair's launches (a
forward walk 1, a reverse walk one a block of samples); :func:`shade_stats`
reads the walks each path took and the rows the kernel shaded and skipped
(it synchronizes: call it outside a step).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..render.light import EnvLight, eval_light, sample_light
from ..utils import kernels
from ..utils.spans import span
from .bsdf import lambert, pbr_specular
from .gather import gather_rows
from .math import (build_orthonormal_basis, cosine_sample, cross, dir_to_latlong_uv, dot, luminance,
                   safe_normalize, sqrt_nonneg)

# ----------------------------------------------------------------------------
# GGX-VNDF importance sampling
# ----------------------------------------------------------------------------


def _eval_ndf_ggx(alpha, cos_theta):
    a2 = alpha * alpha
    d = (cos_theta * a2 - cos_theta) * cos_theta + 1.0
    return a2 / (d * d * math.pi)


def _eval_g1_ggx(alpha_sqr, cos_theta):
    ct2 = cos_theta * cos_theta
    tan2 = torch.clamp(1.0 - ct2, min=0.0) / torch.clamp(ct2, min=1e-12)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha_sqr * tan2))
    return torch.where(cos_theta > 0, g, 0.0)


def _eval_pdf_ggx_vndf(alpha, wo_l, h_l):
    g1 = _eval_g1_ggx(alpha * alpha, wo_l[..., 2:3])
    d = _eval_ndf_ggx(alpha, h_l[..., 2:3])
    return g1 * d * torch.clamp(dot(wo_l, h_l), min=0.0) / torch.clamp(wo_l[..., 2:3], min=1e-6)


def _sample_ggx_vndf(alpha, wo_l, ux, uy):
    """Heitz VNDF sampling → (h_l, pdf)."""
    vh = safe_normalize(torch.cat([alpha * wo_l[..., 0:1], alpha * wo_l[..., 1:2], wo_l[..., 2:3]], -1))
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=vh.dtype, device=vh.device).expand_as(vh)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device).expand_as(vh)
    t1 = torch.where(vh[..., 2:3] < 0.9999, safe_normalize(cross(z_axis, vh)), x_axis)
    t2 = cross(vh, t1)
    r = torch.sqrt(torch.clamp(ux, 0.0, 1.0))[..., None]
    phi = (2.0 * math.pi) * uy[..., None]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2:3])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, 0.0, 1.0)) + s * p2
    nh = t1 * p1 + t2 * p2 + vh * sqrt_nonneg(1.0 - p1 * p1 - p2 * p2)
    h = safe_normalize(
        torch.cat([alpha * nh[..., 0:1], alpha * nh[..., 1:2], torch.clamp(nh[..., 2:3], min=0.0)], -1)
    )
    return h, _eval_pdf_ggx_vndf(alpha, wo_l, h)


def _to_local(v, u_ax, v_ax, w_ax):
    return torch.cat([dot(v, u_ax), dot(v, v_ax), dot(v, w_ax)], dim=-1)


def _to_world(v, u_ax, v_ax, w_ax):
    return u_ax * v[..., 0:1] + v_ax * v[..., 1:2] + w_ax * v[..., 2:3]


def ggx_sample(n, wo, u, v, alpha):
    """Sample a GGX reflection direction → (wi, pdf)."""
    w_ax = safe_normalize(n)
    u_ax, v_ax = build_orthonormal_basis(w_ax)
    wo_l = safe_normalize(_to_local(wo, u_ax, v_ax, w_ax))
    cos_no = wo_l[..., 2:3]
    h, pdf = _sample_ggx_vndf(alpha, wo_l, u, v)
    wo_dot_h = dot(wo_l, h)
    wi_l = h * wo_dot_h * 2.0 - wo_l
    pdf = pdf / torch.clamp(4.0 * wo_dot_h, min=1e-6)
    wi = safe_normalize(_to_world(wi_l, u_ax, v_ax, w_ax))
    ok = cos_no > 0
    return torch.where(ok, wi, 0.0), torch.where(ok, pdf, 0.0)


def ggx_pdf(n, wo, wi, alpha):
    w_ax = safe_normalize(n)
    u_ax, v_ax = build_orthonormal_basis(w_ax)
    wo_l = _to_local(wo, u_ax, v_ax, w_ax)
    wi_l = _to_local(wi, u_ax, v_ax, w_ax)
    m = safe_normalize(wi_l + wo_l)
    wo_dot_h = dot(m, wo_l)
    d = _eval_ndf_ggx(alpha, m[..., 2:3])
    g1 = _eval_g1_ggx(alpha * alpha, wo_l[..., 2:3])
    pdf = g1 * d * torch.clamp(wo_dot_h, min=0.0) / torch.clamp(wo_l[..., 2:3], min=1e-6)
    pdf = pdf / torch.clamp(4.0 * wo_dot_h, min=1e-6)
    ok = (wo_l[..., 2:3] > 0) & (wi_l[..., 2:3] > 0)
    return torch.where(ok, pdf, 0.0)


def _cosine_pdf(n, wi):
    return torch.clamp(dot(n, wi), min=0.0) / math.pi


def bsdf_pdf(p_diffuse, n, wo, wi, alpha):
    """Mixture pdf of the BSDF sampling strategy; lobes gated with where."""
    n_dot_l = dot(n, wi)
    n_dot_v = dot(n, wo)
    degenerate = torch.minimum(n_dot_v, n_dot_l) < 1e-6
    p_spec = 1.0 - p_diffuse
    diff_term = torch.where(p_diffuse > 1e-6, p_diffuse * _cosine_pdf(n, wi), 0.0)
    spec_term = torch.where(p_spec > 1e-6, p_spec * ggx_pdf(n, wo, wi, alpha), 0.0)
    return torch.where(degenerate, 1.0, diff_term + spec_term)


def bsdf_sample(p_diffuse, n, wo, sx, sy, sz, alpha, diffuse_only: bool = False):
    """Sample the diffuse/specular mixture → (wi, pdf)."""
    wi_d, pdf_d = cosine_sample(n, sx, sy)
    if diffuse_only:
        return wi_d, torch.clamp(pdf_d[..., None], min=1e-6)
    wi_s, _ = ggx_sample(n, wo, sx, sy, alpha)
    take_diffuse = (sz < p_diffuse[..., 0])[..., None]
    wi = torch.where(take_diffuse, wi_d, wi_s)
    p_spec = 1.0 - p_diffuse
    pdf = torch.where(p_diffuse > 1e-6, p_diffuse * _cosine_pdf(n, wi), 0.0)
    pdf = pdf + torch.where(p_spec > 1e-6, p_spec * ggx_pdf(n, wo, wi, alpha), 0.0)
    degen = take_diffuse & (p_diffuse < 1e-4)
    n_b = n.expand_as(wi)
    return torch.where(degen, n_b, wi), torch.where(degen, 1.0, pdf)


# ----------------------------------------------------------------------------
# SDF-volume shadow rays
# ----------------------------------------------------------------------------


def trilinear_sdf(grid, p, aabb_min, aabb_scale):
    """Trilinear sample of an (R+1)³ grid at world points ``p`` (..., 3);
    points outside the box read -1 (empty)."""
    r = grid.shape[0] - 1
    q = (p - aabb_min) * aabb_scale * r
    inside = ((q >= 0.0) & (q <= r)).all(dim=-1)
    q = torch.clamp(q, 0.0, r - 1e-4)
    q0 = torch.floor(q).to(torch.int64)
    t = q - q0
    ix, iy, iz = q0[..., 0], q0[..., 1], q0[..., 2]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]

    def g(dx, dy, dz):
        return grid[torch.clamp(ix + dx, max=r), torch.clamp(iy + dy, max=r), torch.clamp(iz + dz, max=r)]

    c00 = g(0, 0, 0) * (1 - tz) + g(0, 0, 1) * tz
    c01 = g(0, 1, 0) * (1 - tz) + g(0, 1, 1) * tz
    c10 = g(1, 0, 0) * (1 - tz) + g(1, 0, 1) * tz
    c11 = g(1, 1, 0) * (1 - tz) + g(1, 1, 1) * tz
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return torch.where(inside, c0 * (1 - tx) + c1 * tx, -1.0)


class SdfVisibility(NamedTuple):
    """An occupancy grid marched along shadow rays + the static march
    (JAX ``VisibilityCfg`` and its consts): ``n_steps`` samples at
    t0 + dt·(i + ½), occluded where the largest sample exceeds
    ``threshold``."""

    grid: torch.Tensor  # (r + 1,)³, occupied where > threshold
    t0: float
    dt: float
    n_steps: int
    threshold: float
    mode: str  # "nearest" or "trilinear"
    r: int
    aabb_min: tuple
    aabb_scale: tuple


def make_sdf_visibility(sdf_grid, aabb_min, aabb_size, n_steps: int = 24, t_min_vox: float = 2.0,
                        occlusion_threshold: float = 0.0, mode: str = "nearest",
                        max_grid_res: int = 65) -> SdfVisibility:
    """The marcher over ``sdf_grid`` (occupied where > threshold), max-pooled
    to at most ``max_grid_res`` per side (JAX ``make_sdf_visibility_parts``):
    the march starts ``t_min_vox`` voxels off the surface and spans the
    box's diagonal."""
    if mode not in ("nearest", "trilinear"):
        raise ValueError(f"mode {mode!r}: nearest or trilinear")
    diag = float(np.linalg.norm(np.asarray(aabb_size, np.float64)))
    grid = _downsample_occupancy(sdf_grid.detach(), max_grid_res)
    r = grid.shape[0] - 1
    t0 = t_min_vox * diag / max(r, 1)
    return SdfVisibility(
        grid=grid, t0=t0, dt=(diag - t0) / n_steps, n_steps=n_steps, threshold=occlusion_threshold,
        mode=mode, r=r, aabb_min=tuple(float(v) for v in np.asarray(aabb_min, np.float64)),
        aabb_scale=tuple(float(v) for v in 1.0 / np.asarray(aabb_size, np.float64)),
    )


def _march(vis: SdfVisibility, ro, rd):
    """1 where no sample along the ray exceeds the threshold.  Sample
    distances are computed in f32 as JAX's loop computes them."""
    grid, r = vis.grid, vis.r
    n = r + 1
    flat = grid.reshape(-1)
    f32 = lambda v: torch.tensor(v, dtype=ro.dtype, device=ro.device)
    aabb_min, aabb_scale = f32(vis.aabb_min), f32(vis.aabb_scale)
    t0, dt = f32(vis.t0), f32(vis.dt)
    occ = torch.full(ro.shape[:-1], -math.inf, dtype=ro.dtype, device=ro.device)
    for i in range(vis.n_steps):
        p = ro + rd * (t0 + dt * f32(i + 0.5))
        if vis.mode == "trilinear":
            s = trilinear_sdf(grid, p, aabb_min, aabb_scale)
        else:
            q = (p - aabb_min) * aabb_scale * r
            inside = ((q >= 0.0) & (q <= r)).all(dim=-1)
            qi = torch.clamp(torch.round(q).to(torch.int64), 0, r)
            s = torch.where(inside, flat[(qi[..., 0] * n + qi[..., 1]) * n + qi[..., 2]], -1.0)
        occ = torch.maximum(occ, s)
    return (occ <= vis.threshold).to(ro.dtype)[..., None]


# ----------------------------------------------------------------------------
# Swept directional shadow field
# ----------------------------------------------------------------------------


class ShadowField(NamedTuple):
    """Bit-packed (K, n, n, words) visibility volumes + static lookup config."""

    field: torch.Tensor  # (K·n·n·words,) int64 words, bit z%32 of word z//32
    ko: int  # octahedral bins per side (K = ko²)
    r: int  # volume res (n = r + 1)
    words: int
    t0: float  # self-shadow offset along the sample direction (world)
    aabb_min: tuple
    aabb_scale: tuple


def _oct_bin_centers(ko: int):
    c = (np.arange(ko) + 0.5) / ko * 2.0 - 1.0
    fx, fy = np.meshgrid(c, c, indexing="ij")
    z = 1.0 - np.abs(fx) - np.abs(fy)
    t = np.clip(-z, 0.0, 1.0)
    x = fx - np.where(fx >= 0, 1.0, -1.0) * t
    y = fy - np.where(fy >= 0, 1.0, -1.0) * t
    d = np.stack([x, y, z], -1).reshape(-1, 3)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def oct_bin_index(rd, ko: int):
    """Flat octahedral bin index of unit directions rd (..., 3)."""
    ax = torch.abs(rd)
    s = torch.clamp(ax[..., 0] + ax[..., 1] + ax[..., 2], min=1e-12)
    px, py = rd[..., 0] / s, rd[..., 1] / s
    sgn = lambda v: torch.where(v >= 0, 1.0, -1.0)
    px2 = (1.0 - torch.abs(py)) * sgn(px)
    py2 = (1.0 - torch.abs(px)) * sgn(py)
    neg = rd[..., 2] < 0
    u = torch.where(neg, px2, px) * 0.5 + 0.5
    v = torch.where(neg, py2, py) * 0.5 + 0.5
    iu = torch.clamp((u * ko).to(torch.int64), 0, ko - 1)
    iv = torch.clamp((v * ko).to(torch.int64), 0, ko - 1)
    return iu * ko + iv


def _downsample_occupancy(grid, max_grid_res: int):
    """Conservative (max-pool) 2× downsampling until res ≤ max_grid_res."""
    while grid.shape[0] > max_grid_res and (grid.shape[0] - 1) % 2 == 0:
        rr = grid.shape[0] - 1
        g = grid
        sub = torch.stack([
            g[dx:dx + rr:2, dy:dy + rr:2, dz:dz + rr:2]
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
        ]).amax(dim=0)
        sub = F.pad(sub[None, None], (0, 1, 0, 1, 0, 1), mode="replicate")[0, 0]
        sub[-1] = torch.maximum(sub[-1], g[-1, ::2, ::2])
        grid = sub
    return grid


def _sweep_shadow_group(vol, shifts_u, shifts_v):
    """Occlusion sweep for D directions sharing a dominant axis/sign.

    ``vol`` (n, nu, nv) occupancy, axis 0 = travel toward the light;
    ``shifts_u/v`` (n, D) per-slice DDA increments in {-1, 0, 1}.  Returns
    (D, n, nu, nv): out[d, k] = 1 where an occupied voxel lies along
    direction d strictly beyond slice k."""
    n, nu, nv = vol.shape
    d = shifts_u.shape[1]

    def shift1(b, delta, axis):
        if axis == 1:
            bp = F.pad(b, (0, 0, 1, 1))
            lo, hi = bp[:, 0:nu], bp[:, 2:nu + 2]
        else:
            bp = F.pad(b, (1, 1))
            lo, hi = bp[:, :, 0:nv], bp[:, :, 2:nv + 2]
        dexp = delta.reshape(d, 1, 1)
        return torch.where(dexp == -1, lo, torch.where(dexp == 0, b, hi))

    carry = torch.zeros((d, nu, nv), dtype=vol.dtype, device=vol.device)
    outs = [None] * n
    for k in range(n - 1, -1, -1):
        outs[k] = carry
        b = torch.maximum(vol[k][None], carry)
        carry = shift1(shift1(b, shifts_u[k], 1), shifts_v[k], 2)
    return torch.stack(outs, dim=1)


def splat_lattice(pts, aabb_min, aabb_size, res: int = 65):
    """0/1 occupancy of surface samples ``pts`` (N, 3) binned into a res³
    lattice over the box → (occ, coverage).  ``coverage`` says how well the
    samples cover the surface: ``splat_cells`` occupied cells,
    ``splat_samples_per_cell`` their mean sample count and
    ``splat_singletons`` the cells only one sample reached (by the
    Good-Turing estimate, singletons / samples is the share of the surface
    that lies in cells no sample reached)."""
    amin = torch.as_tensor(aabb_min, dtype=torch.float32, device=pts.device)
    asz = torch.as_tensor(aabb_size, dtype=torch.float32, device=pts.device)
    ijk = torch.clamp(((pts - amin) / asz * (res - 1)).to(torch.int64), 0, res - 1)
    counts = torch.bincount((ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2], minlength=res**3)
    occ = (counts > 0).to(torch.float32).reshape(res, res, res)
    cells = occ.sum()
    return occ, {
        "splat_cells": cells,
        "splat_samples_per_cell": pts.shape[0] / torch.clamp(cells, min=1.0),
        "splat_singletons": (counts == 1).sum(),
    }


def make_shadow_field(occ_grid, aabb_min, aabb_size, ko: int = 16, t_min_vox: float = 2.0,
                      occlusion_threshold: float = 0.0, max_grid_res: int = 65) -> ShadowField:
    """Sweep an occupancy lattice into K = ko² bit-packed directional
    visibility volumes (JAX ``make_shadow_field_parts`` :444)."""
    dev = occ_grid.device
    grid = _downsample_occupancy(occ_grid.detach(), max_grid_res)
    occ = (grid > occlusion_threshold).float()
    n = occ.shape[0]
    r = n - 1
    k_total = ko * ko
    dirs = _oct_bin_centers(ko)
    field = torch.zeros((k_total, n, n, n), dtype=torch.float32, device=dev)
    axes_dom = np.argmax(np.abs(dirs), axis=-1)
    signs = np.sign(dirs[np.arange(k_total), axes_dom])
    for a in range(3):
        perm = (a, (a + 1) % 3, (a + 2) % 3)
        inv = tuple(int(np.argsort(perm)[i]) for i in range(3))
        for s in (1.0, -1.0):
            sel = np.nonzero((axes_dom == a) & (signs == s))[0]
            if sel.size == 0:
                continue
            dgrp = dirs[sel]
            dom = np.abs(dgrp[:, a])
            du = dgrp[:, perm[1]] / dom
            dv = dgrp[:, perm[2]] / dom
            ks = np.arange(n)[:, None]
            su = np.round(ks * du[None]) - np.round((ks - 1) * du[None])
            sv = np.round(ks * dv[None]) - np.round((ks - 1) * dv[None])
            vol = occ.permute(perm)
            if s < 0:
                vol = torch.flip(vol, dims=(0,))
            out = _sweep_shadow_group(
                vol, torch.as_tensor(su, dtype=torch.int64, device=dev),
                torch.as_tensor(sv, dtype=torch.int64, device=dev),
            )
            if s < 0:
                out = torch.flip(out, dims=(1,))
            out = out.permute((0,) + tuple(i + 1 for i in inv))
            field[torch.as_tensor(sel, device=dev)] = out
    words = (n + 31) // 32
    bits = F.pad(field, (0, words * 32 - n)).to(torch.int64)
    bits = bits.reshape(k_total, n, n, words, 32)
    packed = (bits << torch.arange(32, device=dev)).sum(dim=-1)
    diag = float(np.linalg.norm(np.asarray(aabb_size, np.float64)))
    return ShadowField(
        field=packed.reshape(-1), ko=ko, r=r, words=words,
        t0=t_min_vox * diag / max(r, 1),
        aabb_min=tuple(float(v) for v in np.asarray(aabb_min, np.float64)),
        aabb_scale=tuple(float(v) for v in 1.0 / np.asarray(aabb_size, np.float64)),
    )


def apply_visibility(vis, ro, rd):
    """Shadow test of a :class:`ShadowField` or an :class:`SdfVisibility`:
    1 = light reaches ro along rd, 0 = occluded.  (..., 1)."""
    if isinstance(vis, SdfVisibility):
        return _march(vis, ro, rd)
    n = vis.r + 1
    aabb_min = torch.tensor(vis.aabb_min, dtype=ro.dtype, device=ro.device)
    aabb_scale = torch.tensor(vis.aabb_scale, dtype=ro.dtype, device=ro.device)
    k = oct_bin_index(rd, vis.ko)
    q = (ro + rd * vis.t0 - aabb_min) * aabb_scale * vis.r
    inside = ((q >= 0.0) & (q <= vis.r)).all(dim=-1)
    qi = torch.clamp(torch.round(q).to(torch.int64), 0, vis.r)
    z = qi[..., 2]
    idx = ((k * n + qi[..., 0]) * n + qi[..., 1]) * vis.words + z // 32
    occluded = (vis.field[idx] >> (z % 32)) & 1
    return torch.where(inside, 1.0 - occluded.to(ro.dtype), 1.0)[..., None]


# ----------------------------------------------------------------------------
# Memory-free Monte-Carlo accumulation
# ----------------------------------------------------------------------------


class _MCAccumulate(torch.autograd.Function):
    """Σ over sample blocks of ``walk.block(args, j, aux)`` with O(P) memory.

    Every block's contribution shares the same upstream gradient, so the
    backward re-walks the blocks and sums each block's input gradients
    instead of keeping 64 steps of residuals (JAX ``_mc_accumulate`` :540).
    The forward keeps each block's shadow visibilities (``aux``) so the
    re-walk does not repeat the shadow lookups.  The re-walk is the span
    ``recon.shade_backward``."""

    @staticmethod
    def forward(ctx, walk, *tensors):
        _walks["eager"] += 1
        a = dict(zip(walk.names, tensors))
        total, auxs = None, []
        for j in range(walk.n_blocks):
            c, aux = walk.block(a, j, None)
            total = c if total is None else total + c
            auxs.append(aux)
        ctx.walk = walk
        ctx.aux = auxs
        ctx.save_for_backward(*tensors)
        return total

    @staticmethod
    def backward(ctx, g):
        walk = ctx.walk
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad(), span("recon.shade_backward"):
            a = {
                name: t.detach().requires_grad_(True) if nd else t
                for name, t, nd in zip(walk.names, tensors, need)
            }
            leaves = [a[name] for name, nd in zip(walk.names, need) if nd]
            # summed in each input's dtype, as JAX does (the bf16 light texel's
            # cotangent in bf16)
            acc = [torch.zeros_like(l) for l in leaves]
            for j in range(walk.n_blocks):
                c, _ = walk.block(a, j, ctx.aux[j])
                gs = torch.autograd.grad(c, leaves, g, allow_unused=True)
                acc = [x if gi is None else x + gi for x, gi in zip(acc, gs)]
        it = iter(acc)
        return (None,) + tuple(next(it) if nd else None for nd in need)


# Walks taken by each path (plain integers) and, per device, the kernel's
# rows shaded and rows skipped by the mask (int64 (2,), added on the card).
mc_shade_launches = 0
_walks = {"kernel": 0, "eager": 0}
_rows: dict = {}


def _rows_on(device) -> torch.Tensor:
    t = _rows.get(device)
    if t is None:
        t = _rows[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return t


def shade_stats() -> dict:
    """{"kernel_walks", "eager_walks", "rows_shaded", "rows_skipped"} since
    the process started: forward walks of :func:`env_shade` on each path,
    and the rows the kernel's forward walks shaded and skipped (mask 0),
    summed over devices (synchronizes each device it reads)."""
    shaded = skipped = 0
    for t in _rows.values():
        a, b = t.tolist()
        shaded, skipped = shaded + a, skipped + b
    return {"kernel_walks": _walks["kernel"], "eager_walks": _walks["eager"], "rows_shaded": shaded,
            "rows_skipped": skipped}


def takes_kernel(device: torch.device, row_dtypes, light_dtype, visibility) -> bool:
    """Whether :func:`env_shade` walks with the hand kernel: on the card,
    always (raises ``TypeError`` where it cannot take the inputs: pixel rows
    and pool not f32, a light neither f32 nor bf16, a marcher's grid not
    f32); on the CPU, never."""
    if device.type != "cuda":
        return False
    bad = [str(d) for d in row_dtypes if d != torch.float32]
    if light_dtype not in (torch.float32, torch.bfloat16):
        bad.append(f"light {light_dtype}")
    if isinstance(visibility, SdfVisibility) and visibility.grid.dtype != torch.float32:
        bad.append(f"marcher grid {visibility.grid.dtype}")
    if bad:
        raise TypeError(f"env_shade on the card takes f32 pixel rows, pool and marcher grid and an f32 or bf16 "
                        f"light; got {', '.join(bad)}")
    return True


def _kernel_args(walk, rows, pool, light_packed) -> kernels.McShadeArgs:
    """The kernel's arguments for a walk: the draws and constants as the
    eager walk casts them (Python floats to f32)."""
    a = kernels.McShadeArgs()
    vp = ctypes.c_void_p
    a.rows, a.P = vp(rows.data_ptr()), rows.shape[0]
    a.u, a.c = vp(walk.u.data_ptr()), vp(walk.c.data_ptr())
    a.pool, a.n_pool = vp(pool.data_ptr()), pool.shape[1]
    a.light, a.light_bf16 = vp(light_packed.data_ptr()), int(light_packed.dtype == torch.bfloat16)
    a.diffuse_only, a.n = int(walk.diffuse_only), walk.n
    a.lh, a.lw = light_packed.shape[0], light_packed.shape[1]
    a.inv_n2, a.strata = 1.0 / walk.n2, 1.0 / walk.n
    a.ss, a.omss = walk.shadow_scale, 1.0 - walk.shadow_scale
    a.hw = float(a.lh * a.lw)
    vis = walk.vis
    if isinstance(vis, ShadowField):
        a.field, a.ko, a.words = vp(vis.field.data_ptr()), vis.ko, vis.words
    elif vis is not None:
        a.grid, a.n_steps, a.trilinear = vp(vis.grid.data_ptr()), vis.n_steps, int(vis.mode == "trilinear")
        a.dt, a.thr, a.hi = vis.dt, vis.threshold, vis.r - 1e-4
    if vis is not None:
        a.r, a.t0 = vis.r, vis.t0
        a.amin[:], a.ascale[:] = vis.aabb_min, vis.aabb_scale
    a.k = walk.block_size
    return a


def mc_walk_kernel(walk, mask, tensors):
    """The kernel's forward walk: (P, 6) diffuse and specular sums, rows with
    ``mask`` 0 left 0.  Returns (out, rows), the packed pixel rows the
    reverse reads."""
    global mc_shade_launches
    a = dict(zip(walk.names, tensors))
    rows = torch.cat([a["gb_normal"], a["kd"], a["ks"][:, 2:3], a["wo"], a["alpha"], a["p_diffuse"],
                      walk.ro, walk.rot, mask.to(torch.float32)], dim=1).contiguous()
    light = a["light_packed"].contiguous()
    out = torch.empty((rows.shape[0], 6), dtype=torch.float32, device=rows.device)
    args = _kernel_args(walk, rows, a["pool"].contiguous(), light)
    args.out, args.stats = ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(_rows_on(rows.device).data_ptr())
    kernels.check(kernels.lib().gs_mc_shade_fwd(ctypes.byref(args), ctypes.c_void_p(kernels.stream_ptr(rows))),
                  "mc_shade_fwd")
    mc_shade_launches += 1
    return out, rows


def mc_rewalk_kernel(walk, rows, pool, light, g, need=(True,) * 8):
    """The kernel's reverse walk, one launch a block of samples: the
    cotangents of the walk's eight inputs (``_ShadeWalk.names``) for the
    (P, 6) cotangent ``g``, None where ``need`` is false; the pool's and the
    light's are computed only if needed."""
    global mc_shade_launches
    p, dev = rows.shape[0], rows.device
    g_rows = torch.zeros((p, 12), dtype=torch.float32, device=dev)
    g_pool = torch.zeros_like(pool) if need[6] else None
    g_light = torch.zeros_like(light) if need[7] else None
    g = g.contiguous()
    args = _kernel_args(walk, rows, pool, light)
    vp = ctypes.c_void_p
    args.g, args.g_rows = vp(g.data_ptr()), vp(g_rows.data_ptr())
    if g_pool is not None:
        args.g_pool = vp(g_pool.data_ptr())
    if g_light is not None:
        scratch = torch.zeros(light.shape, dtype=torch.float32, device=dev)
        args.scratch, args.g_light = vp(scratch.data_ptr()), vp(g_light.data_ptr())
    stream = vp(kernels.stream_ptr(rows))
    for j in range(walk.n_blocks):
        args.j0 = j * walk.block_size
        kernels.check(kernels.lib().gs_mc_shade_bwd(ctypes.byref(args), stream), "mc_shade_bwd")
        mc_shade_launches += 1
    g_ks = torch.cat([torch.zeros((p, 2), dtype=torch.float32, device=dev), g_rows[:, 6:7]], dim=1)
    grads = (g_rows[:, 0:3], g_rows[:, 3:6], g_ks, g_rows[:, 7:10], g_rows[:, 10:11], g_rows[:, 11:12],
             g_pool, g_light)
    return tuple(x if nd else None for x, nd in zip(grads, need))


class _MCShade(torch.autograd.Function):
    """:class:`_MCAccumulate` as the hand kernel pair ``csrc/mc_shade.cu``.
    The forward walks every sample in one launch; the backward re-walks one
    block of ``walk.block_size`` samples a launch, as the eager re-walk sums
    them, in the span ``recon.shade_backward``.  Rows with ``mask`` 0 read
    0 and send no cotangent (``env_shade`` zeroes them on the way out)."""

    @staticmethod
    def forward(ctx, walk, mask, *tensors):
        _walks["kernel"] += 1
        out, rows = mc_walk_kernel(walk, mask, tensors)
        ctx.walk = walk
        ctx.save_for_backward(rows, tensors[6].contiguous(), tensors[7].contiguous())
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        rows, pool, light = ctx.saved_tensors
        with span("recon.shade_backward"):
            grads = mc_rewalk_kernel(ctx.walk, rows, pool, light, g, ctx.needs_input_grad[2:])
        return (None, None) + grads


class ShadeBuffers(NamedTuple):
    diffuse: torch.Tensor  # (P, 3) demodulated diffuse light
    specular: torch.Tensor  # (P, 3)


def _pixel_probabilities(kd, ks, wo, nrm):
    """Lobe selection probability (ref kernel.cu:495-502)."""
    metallic = ks[..., 2:3]
    spec_col = 0.04 * (1.0 - metallic) + kd * metallic
    diffuse_weight = (1.0 - metallic) * luminance(kd)
    cos_no = dot(wo, nrm)
    f = spec_col + (1.0 - spec_col) * (1.0 - torch.clamp(cos_no, 1e-4, 1.0 - 1e-4)) ** 5
    specular_weight = torch.where(cos_no > 0, luminance(f), 0.0)
    total = diffuse_weight + specular_weight
    return torch.where(total > 0, diffuse_weight / torch.clamp(total, min=1e-12), 1.0)


class _ShadeWalk:
    """The per-block sample evaluation of :func:`env_shade` (closure state:
    draws, strata, the shadow field or marcher)."""

    names = ("gb_normal", "kd", "ks", "wo", "alpha", "p_diffuse", "pool", "light_packed")

    def __init__(self, n_samples_x, block, diffuse_only, shadow_scale, vis, ro, rot, u, c):
        self.n = n_samples_x
        self.n2 = n_samples_x * n_samples_x
        self.block_size = block
        self.n_blocks = self.n2 // block
        self.diffuse_only = diffuse_only
        self.shadow_scale = shadow_scale
        self.vis, self.ro, self.rot, self.u, self.c = vis, ro, rot, u, c

    def block(self, a, j, aux):
        dev = self.ro.device
        steps = torch.arange(j * self.block_size, (j + 1) * self.block_size, device=dev)
        k = steps.shape[0]
        gn, kd, ks = a["gb_normal"][None], a["kd"][None], a["ks"][None]
        wo, alpha, p_diffuse = a["wo"][None], a["alpha"][None], a["p_diffuse"][None]
        pool = a["pool"]
        p = gn.shape[1]
        n_pool = pool.shape[1]
        strata = 1.0 / self.n
        n2 = self.n2
        u = self.u[steps]  # (k, P, 3)
        ss = self.shadow_scale

        def eval_sample(ray_dir, pdf_sum, vis, light_col):
            mis = 1.0 / torch.clamp(pdf_sum, min=1e-4)
            diff = lambert(gn, ray_dir)
            if self.diffuse_only:
                spec = torch.zeros_like(diff)
            else:
                metallic = ks[..., 2:3]
                spec_col = 0.04 * (1.0 - metallic) + kd * metallic
                spec = pbr_specular(spec_col, gn, wo, ray_dir, alpha, min_roughness=0.08)
            v = vis * ss + (1.0 - ss)
            w = mis * (1.0 / n2) * v
            return diff * light_col * w, spec * light_col * w

        def shadow(ray_dir, slot):
            if aux is not None:
                return aux[..., slot:slot + 1]
            if self.vis is None:
                return torch.ones_like(ray_dir[..., :1])
            with torch.no_grad():
                return apply_visibility(self.vis, self.ro[None], ray_dir.detach())

        # strategy 1: light importance sampling from the rotated pool
        idx = (torch.arange(p, device=dev)[None] + self.c[steps][:, None]) % n_pool
        entry = torch.gather(pool[steps], 1, idx[..., None].expand(k, p, 7))
        ray_dir, pdf_l, light_col1 = entry[..., 0:3], entry[..., 3:4], entry[..., 4:7]
        if self.diffuse_only:
            pdf_b = _cosine_pdf(gn, ray_dir)
        else:
            pdf_b = bsdf_pdf(p_diffuse, gn, wo, ray_dir, alpha)
        vis1 = shadow(ray_dir, 0)
        d1, s1 = eval_sample(ray_dir, pdf_l + pdf_b, vis1, light_col1)

        # strategy 2: BSDF sampling
        sx_i = (steps % self.n).to(torch.float32)[:, None]
        sy_i = (steps // self.n).to(torch.float32)[:, None]
        bu = torch.remainder((sx_i + u[..., 0]) * strata + self.rot[None, :, 0], 1.0)
        bv = torch.remainder((sy_i + u[..., 1]) * strata + self.rot[None, :, 1], 1.0)
        ray_dir2, pdf_b2 = bsdf_sample(
            p_diffuse, gn, wo, bu, bv, u[..., 2], alpha, diffuse_only=self.diffuse_only
        )
        lp = a["light_packed"]
        hh, ww = lp.shape[0], lp.shape[1]
        uv2 = dir_to_latlong_uv(ray_dir2)
        lx = torch.clamp((uv2[..., 0] * ww).to(torch.int64), 0, ww - 1)
        ly = torch.clamp((uv2[..., 1] * hh).to(torch.int64), 0, hh - 1)
        texel = gather_rows(lp.reshape(hh * ww, -1), ly * ww + lx).float()  # radiance + selection pdf
        sin_t = torch.clamp(torch.sin(uv2[..., 1:2] * math.pi), min=1e-4)
        pdf_l2 = texel[..., 3:4] * (hh * ww) / (2.0 * math.pi * math.pi * sin_t)
        vis2 = shadow(ray_dir2, 1)
        d2, s2 = eval_sample(ray_dir2, pdf_l2 + pdf_b2, vis2, texel[..., 0:3])

        contrib = torch.cat([d1 + d2, s1 + s2], dim=-1).sum(dim=0)  # (P, 6)
        return contrib, torch.cat([vis1, vis2], dim=-1)


def env_shade(draws, mask, ro, gb_pos, gb_normal, view_pos, kd, ks, light: EnvLight,
              n_samples_x: int = 8, bsdf: str = "pbr", shadow_scale: float = 1.0,
              visibility: ShadowField | SdfVisibility | None = None, light_pool: int = 4096,
              mc_block: int = 8, light_bf16: bool = True) -> ShadeBuffers:
    """(demodulated diffuse, specular) radiance per pixel; inputs are
    flattened pixel rows (P, 3)/(P, 1).  Draws: ``rot`` (P, 2), ``pool``
    (n², light_pool, 2), and per step s ``u/step{s}`` (P, 3) and
    ``c/step{s}`` (the pool rotation).  On the card the walk is the hand
    kernel pair (:func:`takes_kernel` says what it takes); on the CPU, the
    eager walk."""
    dev = gb_pos.device
    p = gb_pos.shape[0]
    n2 = n_samples_x * n_samples_x
    strata = 1.0 / n_samples_x
    diffuse_only = bsdf in ("diffuse", "white")
    block = max(1, min(mc_block, n2))
    while n2 % block:
        block -= 1

    rot = draws.uniform("rot", (p, 2))
    step_f = torch.arange(n2, dtype=torch.float32, device=dev)
    sx_idx, sy_idx = step_f % n_samples_x, torch.div(step_f, n_samples_x, rounding_mode="floor")
    ju = draws.uniform("pool", (n2, light_pool, 2))
    lu_pool = (sx_idx[:, None] + ju[..., 0]) * strata
    lv_pool = (sy_idx[:, None] + ju[..., 1]) * strata
    pool_dirs, pool_pdf = sample_light(light, lu_pool.reshape(-1), lv_pool.reshape(-1))
    pool_col = eval_light(light, pool_dirs)
    pool = torch.cat([pool_dirs, pool_pdf, pool_col], dim=-1).reshape(n2, light_pool, 7)

    light_packed = torch.cat([light.base, light.pdf[..., None].to(light.base.dtype)], dim=-1)
    if light_bf16:
        light_packed = light_packed.to(torch.bfloat16)

    wo_pre = safe_normalize(view_pos - gb_pos)
    alpha_pre = ks[..., 1:2] * ks[..., 1:2]
    p_diffuse_pre = (
        torch.ones_like(alpha_pre) if diffuse_only
        else _pixel_probabilities(kd, ks, wo_pre, gb_normal)
    )
    u = torch.stack([draws.uniform(f"u/step{s}", (p, 3)) for s in range(n2)])
    c = torch.stack([draws.randint(f"c/step{s}", (), 0, light_pool) for s in range(n2)]).to(dev)
    walk = _ShadeWalk(n_samples_x, block, diffuse_only, float(shadow_scale), visibility,
                      ro.detach(), rot, u, c)
    args = dict(gb_normal=gb_normal, kd=kd, ks=ks, wo=wo_pre, alpha=alpha_pre,
                p_diffuse=p_diffuse_pre, pool=pool, light_packed=light_packed)
    tensors = [args[n] for n in _ShadeWalk.names]
    if takes_kernel(gb_pos.device, [t.dtype for t in tensors[:7]] + [ro.dtype], light_packed.dtype, visibility):
        acc = _MCShade.apply(walk, mask.reshape(p, 1).detach(), *tensors)
    else:
        acc = _MCAccumulate.apply(walk, *tensors)
    m = mask.reshape(p, 1).to(acc.dtype)
    return ShadeBuffers(diffuse=acc[:, :3] * m, specular=acc[:, 3:] * m)
