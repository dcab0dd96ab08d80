"""Differentiable mesh → image-buffer rendering (PyTorch twin of
``gshell_tpu/render/render.py``): clip transform → binned rasterization (the
scan off the 16-pixel tile grid) → G-buffer interpolation → foreground
compaction → material (the hash-grid field) → Monte-Carlo environment
shading → bilateral denoise (before or after modulation) → composite +
silhouette antialias, at ``resolution·spp`` and average-pooled back down.
One depth layer; the port's second layer, texture maps and UV bake are not
copied."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bsdf as bsdf_ops
from ..ops.denoiser import bilateral_denoiser
from ..ops.math import abs_tie_up, avg_pool_nhwc, safe_normalize, xfm_points
from ..ops.mesh_ops import face_normals as compute_face_normals
from ..ops.rasterize import TILE, Rast, antialias, bary_screen_derivs, interpolate, rasterize, rasterize_tiled
from ..ops.shade import ShadowField, env_shade
from .light import EnvLight
from .material import MLPTexture3DConfig, sample_mlp_texture

SHADING_BSDFS = ("pbr", "diffuse", "white")  # shaded by the MC walk; "normal", "kd", "ks" show a buffer


class RenderFlags(NamedTuple):
    resolution: tuple = (512, 512)
    n_samples: int = 8
    # supersampling: rasterize and shade at resolution·spp, average-pool
    # every image buffer back down
    spp: int = 1
    bsdf: str = "pbr"
    # denoise diffuse and specular light before modulation by kd (one
    # 6-channel stencil), else the modulated colour (3 channels)
    denoiser_demodulate: bool = True
    use_denoiser: bool = True
    jitter_std: float = 0.01  # world-space material jitter
    # foreground-compaction budget as a fraction of the image (None = off)
    shade_budget: float | None = None
    mc_block: int = 8
    light_bf16: bool = True
    jitter_tap_frac: float = 0.25
    max_pairs: int | None = None  # stage A's pair buffer (None: max(8·F, 4096))


def rasterize_view(v_clip, faces, flags: RenderFlags, resolution) -> Rast:
    """The nearest layer of a view at ``resolution``: binned on the 16-pixel
    tile grid, else the scan, as the port's ``render_mesh`` chooses."""
    h, w = resolution
    if h % TILE == 0 and w % TILE == 0:
        return rasterize_tiled(v_clip, faces, (h, w), max_pairs=flags.max_pairs)
    return rasterize(v_clip, faces, (h, w))


def _fg_compact_idx(tri_id, p_full: int, budget: float | None):
    """Foreground-first stable permutation for a ``shade_budget`` fraction →
    ((perm, inv, n_slots) | None, dropped foreground pixels)."""
    zero = torch.zeros((), dtype=torch.int64, device=tri_id.device)
    if budget is None:
        return None, zero
    n_slots = min(p_full, -(-int(p_full * budget) // 1024) * 1024)
    if n_slots >= p_full:
        return None, zero
    fg = (tri_id > 0).reshape(p_full)
    perm = torch.argsort((~fg).to(torch.int32), stable=True)
    inv = torch.argsort(perm)
    dropped = torch.clamp(fg.sum() - n_slots, min=0)
    return (perm, inv, n_slots), dropped


class _PermuteCompact(torch.autograd.Function):
    """``img_flat[perm[:n]]`` whose backward is the gather
    ``cat(g, 0)[inv]`` (perm is a permutation) instead of a scatter."""

    @staticmethod
    def forward(ctx, img_flat, perm, inv, n_slots):
        ctx.save_for_backward(inv)
        ctx.shape = (img_flat.shape[0] - n_slots,) + tuple(img_flat.shape[1:])
        return img_flat[perm[:n_slots]]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        pad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return torch.cat([g, pad], dim=0)[inv], None, None, None


class _PermuteScatter(torch.autograd.Function):
    """Inverse of :class:`_PermuteCompact`: rows back at their pixels (zeros
    elsewhere) — a gather by ``inv`` forward, by ``perm`` backward."""

    @staticmethod
    def forward(ctx, rows, perm, inv, p_full):
        ctx.save_for_backward(perm)
        ctx.n = rows.shape[0]
        pad = torch.zeros((p_full - rows.shape[0],) + tuple(rows.shape[1:]),
                          dtype=rows.dtype, device=rows.device)
        return torch.cat([rows, pad], dim=0)[inv]

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        return g[perm[:ctx.n]], None, None, None


def _roll(img, shift):
    return torch.roll(img, shifts=(int(shift[0]), int(shift[1])), dims=(0, 1))


def render_mesh(draws, verts, faces, v_nrm, msdf, mat_params, mat_cfg: MLPTexture3DConfig,
                mvp, campos, light: EnvLight, flags: RenderFlags, background=None,
                visibility: ShadowField | None = None, shadow_scale: float = 1.0,
                denoiser_sigma: float = 2.0) -> dict:
    """Render one view → the reference's buffer dict, (H, W, C) layout.

    ``mat_params``: the neural material's dict.  Draws (names under
    ``draws``): ``tangent``, ``nrm_shift``, ``shade/...``, ``jitter_off``,
    ``jitter`` and ``tex/hashgrid/sel``."""
    spp = flags.spp
    h, w = flags.resolution[0] * spp, flags.resolution[1] * spp
    dev = verts.device
    bsdf = flags.bsdf

    # ---- geometry pass ----------------------------------------------------
    v_clip = xfm_points(verts, mvp)
    rast = rasterize_view(v_clip, faces, flags, (h, w))
    mask = (rast.tri_id > 0).float()[..., None]

    attr_list = [verts, v_nrm, v_clip]
    if msdf is not None:
        attr_list.append(msdf[:, None])
    gb_attr = interpolate(torch.cat(attr_list, dim=-1), rast, faces, v_clip=v_clip)
    gb_pos = gb_attr[..., 0:3]
    gb_normal_smooth = gb_attr[..., 3:6]
    clip_i = gb_attr[..., 6:10]
    msdf_image = gb_attr[..., 10:11] if msdf is not None else None

    fn = compute_face_normals(verts, faces)
    fid = torch.clamp(rast.tri_id - 1, min=0)
    gb_geo_normal = fn[fid] * mask

    noise = safe_normalize(draws.normal("tangent", gb_normal_smooth.shape))
    gb_tangent = torch.linalg.cross(noise, gb_normal_smooth)

    db = bary_screen_derivs(rast, faces, v_clip)

    def screen_derivs(tri):  # d(attr)/dx, d(attr)/dy of per-corner values (H, W, 3, C)
        e02 = tri[..., 0, :] - tri[..., 2, :]
        e12 = tri[..., 1, :] - tri[..., 2, :]
        return db[..., 0:1] * e02 + db[..., 2:3] * e12, db[..., 1:2] * e02 + db[..., 3:4] * e12

    dattr_dx, dattr_dy = screen_derivs(v_clip[faces[fid]])
    eps = 1e-5
    z0 = torch.clamp(clip_i[..., 2:3], min=eps) / torch.clamp(clip_i[..., 3:4], min=eps)
    dz = torch.abs(dattr_dx[..., 2:3]) + torch.abs(dattr_dy[..., 2:3])
    dw = torch.abs(dattr_dx[..., 3:4]) + torch.abs(dattr_dy[..., 3:4])
    z1 = torch.clamp(clip_i[..., 2:3] + dz, min=eps) / torch.clamp(clip_i[..., 3:4] + dw, min=eps)
    gb_depth = torch.cat([z0, torch.abs(z1 - z0)], dim=-1).detach()

    # ---- foreground-pixel compaction ---------------------------------------
    p_full = h * w
    idx_c, px_dropped = _fg_compact_idx(rast.tri_id, p_full, flags.shade_budget)

    def compact(img):
        perm, inv, n_slots = idx_c
        return _PermuteCompact.apply(img.reshape(p_full, -1), perm, inv, n_slots)

    def scatter(rows, c):
        perm, inv, _ = idx_c
        return _PermuteScatter.apply(rows, perm, inv, p_full).reshape(h, w, c)

    # ---- material pass ------------------------------------------------------
    omit_o = torch.tensor([0.0, 1.0, 1.0], device=dev)
    tex_draws = draws.child("tex")
    pos_m = compact(gb_pos) if idx_c is not None else gb_pos.reshape(p_full, 3)
    if idx_c is not None and flags.jitter_tap_frac < 1.0:
        # jitter tap on a random circular block [off, off + pj) of the rows
        n_sl = pos_m.shape[0]
        pj = min(n_sl, max(1024, int(n_sl * flags.jitter_tap_frac) // 256 * 256))
        off = int(draws.randint("jitter_off", (), 0, n_sl))
        pos_sel = torch.cat([pos_m, pos_m[:pj]], dim=0)[off:off + pj]
        pos_j = pos_sel + flags.jitter_std * draws.normal("jitter", (pj, 3))
        both = sample_mlp_texture(mat_params, mat_cfg, torch.cat([pos_m, pos_j], dim=0),
                                  draws=tex_draws)
        tex_main, tex_j = both[:n_sl], both[n_sl:]
        tm_sel = torch.cat([tex_main, tex_main[:pj]], dim=0)[off:off + pj]
        grad_rows = abs_tie_up(tex_j - tm_sel) * (n_sl / pj)
        gr_ext = torch.nn.functional.pad(grad_rows, (0, 0, off, n_sl - off))
        head = gr_ext[:n_sl]
        grad_full = head + torch.nn.functional.pad(gr_ext[n_sl:], (0, 0, 0, n_sl - pj))
        tex_img = scatter(torch.cat([tex_main, grad_full], dim=-1), 12)
    else:
        jit_pos = pos_m + flags.jitter_std * draws.normal("jitter", pos_m.shape)
        both = sample_mlp_texture(mat_params, mat_cfg, torch.stack([pos_m, jit_pos]),
                                  draws=tex_draws)
        tex_rows = torch.cat([both[0], abs_tie_up(both[1] - both[0])], dim=-1)
        tex_img = scatter(tex_rows, 12) if idx_c is not None else tex_rows.reshape(h, w, 12)
    kd, ks = tex_img[..., 0:3], tex_img[..., 3:6]
    kd_grad = tex_img[..., 6:9] * mask
    ks_grad = tex_img[..., 9:12] * omit_o * mask
    alpha = torch.ones_like(kd[..., 0:1])

    shift = draws.randint("nrm_shift", (2,), -1, 2)
    nrm_grad = abs_tie_up(_roll(gb_normal_smooth, shift) - gb_normal_smooth) * mask

    # ---- shading normal -----------------------------------------------------
    view_pos = campos.reshape(1, 1, 3).expand_as(gb_pos)
    gb_normal = bsdf_ops.prepare_shading_normal(
        gb_pos, view_pos, None, gb_normal_smooth, gb_tangent, gb_geo_normal,
        two_sided_shading=True, opengl=True,
    )

    # ---- Monte-Carlo environment shading ------------------------------------
    diffuse_accum = specular_accum = None
    if bsdf in SHADING_BSDFS:
        kd_eff = torch.ones_like(kd) if bsdf == "white" else kd
        ro = gb_pos + gb_normal * 0.001
        if idx_c is not None:
            packed = compact(torch.cat([ro, gb_pos, gb_normal, kd_eff, ks, mask], dim=-1))
            shade_in = (
                packed[:, 15:16], packed[:, 0:3], packed[:, 3:6], packed[:, 6:9],
                campos.reshape(1, 3).expand(packed.shape[0], 3), packed[:, 9:12], packed[:, 12:15],
            )
        else:
            shade_in = (
                mask.reshape(p_full, 1), ro.reshape(p_full, 3), gb_pos.reshape(p_full, 3),
                gb_normal.reshape(p_full, 3), view_pos.reshape(p_full, 3),
                kd_eff.reshape(p_full, 3), ks.reshape(p_full, 3),
            )
        out = env_shade(
            draws.child("shade"), *shade_in, light, n_samples_x=flags.n_samples, bsdf=bsdf,
            shadow_scale=shadow_scale, visibility=visibility, mc_block=flags.mc_block,
            light_bf16=flags.light_bf16,
        )
        if idx_c is not None:
            ds = scatter(torch.cat([out.diffuse, out.specular], dim=-1), 6)
        else:
            ds = torch.cat([out.diffuse, out.specular], dim=-1).reshape(h, w, 6)
        if flags.use_denoiser and flags.denoiser_demodulate:  # diffuse and specular share the guides: one call
            ds = bilateral_denoiser(ds, gb_normal, gb_depth, denoiser_sigma)
        diffuse_accum, specular_accum = ds[..., 0:3], ds[..., 3:6]

        if bsdf in ("white", "diffuse"):
            shaded_col = diffuse_accum * kd_eff
        else:
            shaded_col = diffuse_accum * (kd_eff * (1.0 - ks[..., 2:3])) + specular_accum
        if flags.use_denoiser and not flags.denoiser_demodulate:
            shaded_col = bilateral_denoiser(shaded_col, gb_normal, gb_depth, denoiser_sigma)
    elif bsdf == "normal":
        shaded_col = (gb_normal + 1.0) * 0.5
    elif bsdf == "kd":
        shaded_col = kd
    elif bsdf == "ks":
        shaded_col = ks
    else:
        raise ValueError(f"invalid BSDF {bsdf!r}")

    # ---- composite + antialias ----------------------------------------------
    if background is None:
        background = torch.zeros((h, w, 3), device=dev)
    elif spp > 1 and background.shape[0] != h:
        background = background.repeat_interleave(spp, dim=0).repeat_interleave(spp, dim=1)
    m_a = mask * alpha
    comp = background * (1.0 - m_a) + shaded_col * m_a
    shaded = antialias(torch.cat([comp, m_a], dim=-1), rast, v_clip, faces)

    dist = torch.sqrt(torch.clamp(torch.sum((gb_pos - view_pos) ** 2, -1, keepdim=True), min=1e-12))
    invdepth = (1.0 / dist) * mask

    buffers = {
        "shaded": shaded,
        "mask": mask,
        "invdepth": torch.cat([invdepth, torch.ones_like(alpha)], -1),
        "kd": torch.cat([kd * mask, alpha], -1),
        "ks": torch.cat([ks * mask, alpha], -1),
        "kd_grad": torch.cat([kd_grad, alpha], -1),
        "ks_grad": torch.cat([ks_grad, alpha], -1),
        "normal_grad": torch.cat([nrm_grad, alpha], -1),
        "normal": torch.cat([gb_normal * mask, alpha], -1),
        "geometric_normal": torch.cat([gb_geo_normal, alpha], -1),
        "z_grad": torch.cat([gb_depth, torch.zeros_like(alpha), alpha], -1),
    }
    if diffuse_accum is not None:
        buffers["diffuse_light"] = torch.cat([diffuse_accum, alpha], -1)
        buffers["specular_light"] = torch.cat([specular_accum, alpha], -1)
    if msdf is not None:
        buffers["msdf_image"] = msdf_image
    if spp > 1:  # every image buffer back to the base resolution
        buffers = {k: avg_pool_nhwc(v[None], spp)[0] for k, v in buffers.items()}

    vis_vert = torch.zeros((verts.shape[0],), dtype=torch.bool, device=dev)
    vis_vert[faces[fid[rast.tri_id > 0]].reshape(-1)] = True
    buffers["visible_vert_mask"] = vis_vert
    buffers["n_raster_dropped"] = rast.dropped
    buffers["n_px_dropped"] = px_dropped
    return buffers

