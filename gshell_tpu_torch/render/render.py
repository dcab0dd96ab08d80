"""Differentiable mesh → image-buffer rendering (PyTorch twin of
``gshell_tpu/render/render.py``): clip transform → binned rasterization (the
scan off the 16-pixel tile grid) → G-buffer interpolation → foreground
compaction → material (the hash-grid field, or Texture2D maps at
interpolated UVs) → Monte-Carlo environment shading → bilateral denoise
(before or after modulation) → composite + silhouette antialias, at
``resolution·spp`` and average-pooled back down.  :func:`render_second_layer`
shades the second-nearest surface the same way, without the denoiser;
:func:`render_uv` bakes the neural material into a UV atlas."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bsdf as bsdf_ops
from ..ops.denoiser import bilateral_denoiser
from ..ops.math import abs_tie_up, avg_pool_nhwc, safe_normalize, xfm_points
from ..ops.mesh_ops import face_normals as compute_face_normals
from ..ops.rasterize import (TILE, antialias, bary_screen_derivs, interpolate, rasterize, rasterize_peel,
                             rasterize_tiled_peel)
from ..ops.shade import ShadowField, SdfVisibility, env_shade
from ..utils.spans import span
from . import texture as tex2d
from .light import EnvLight
from .material import MLPTexture3DConfig, TextureMaterial, sample_mlp_texture

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


def rasterize_layers(v_clip, faces, flags: RenderFlags, n_layers: int = 1, resolution=None) -> list:
    """The first ``n_layers`` (1 or 2) depth layers of a view at
    ``resolution`` (default ``flags.resolution``): the binned peel on the
    16-pixel tile grid (stage B, then its second layer over the same
    segments), else the scan, as JAX's ``render_mesh`` chooses."""
    h, w = resolution or flags.resolution
    if h % TILE == 0 and w % TILE == 0:
        return rasterize_tiled_peel(v_clip, faces, (h, w), max_pairs=flags.max_pairs, n_layers=n_layers)
    return rasterize_peel(v_clip, faces, (h, w), n_layers=n_layers)


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
                visibility: ShadowField | SdfVisibility | None = None, shadow_scale: float = 1.0,
                denoiser_sigma: float = 2.0, n_layers: int = 1, v_tex=None, t_tex_idx=None) -> dict:
    """Render one view → the reference's buffer dict, (H, W, C) layout.

    ``mat_params``: the neural material's dict, or a :class:`TextureMaterial`
    sampled at the UVs ``v_tex`` (T, 2) through ``t_tex_idx`` (F, 3).
    Draws (names under ``draws``): ``tangent``, ``nrm_shift`` and
    ``shade/...``; the neural material's ``jitter_off``, ``jitter`` and
    ``tex/hashgrid/sel``, a texture's ``tex_shift``.  With ``n_layers`` 2,
    ``rast_second`` holds layer 2 for :func:`render_second_layer` at the
    base resolution: at ``spp`` 1 peeled from the same bins and stage-B
    winners, else from a second raster of the view at base resolution.
    Spans: ``recon.raster`` (the geometry pass), ``recon.material``,
    ``recon.shade`` (the MC walk) and ``recon.denoise``."""
    spp = flags.spp
    h, w = flags.resolution[0] * spp, flags.resolution[1] * spp
    dev = verts.device
    bsdf = flags.bsdf

    # ---- geometry pass ----------------------------------------------------
    with span("recon.raster"):
        v_clip = xfm_points(verts, mvp)
        layers = rasterize_layers(v_clip, faces, flags, n_layers if spp == 1 else 1, (h, w))
        rast = layers[0]
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
    with span("recon.material"):
        omit_o = torch.tensor([0.0, 1.0, 1.0], device=dev)
        perturbed_nrm = None
        if isinstance(mat_params, TextureMaterial):
            if v_tex is None or t_tex_idx is None:
                raise ValueError("a TextureMaterial needs the v_tex / t_tex_idx UV attributes")
            # UVs interpolated with the position triangle's barycentrics
            gb_texc = interpolate(v_tex, rast, t_tex_idx, v_clip=v_clip, pos_faces=faces)
            duv_dx, duv_dy = screen_derivs(v_tex[t_tex_idx[fid]])
            uv_da = torch.cat([duv_dx[..., 0:1], duv_dy[..., 0:1], duv_dx[..., 1:2], duv_dy[..., 1:2]], -1).detach()
            kd4 = tex2d.sample(mat_params.kd, gb_texc, uv_da)
            alpha = kd4[..., 3:4] if kd4.shape[-1] == 4 else torch.ones_like(kd4[..., 0:1])
            kd = kd4[..., 0:3]
            ks = tex2d.sample(mat_params.ks, gb_texc, uv_da)[..., 0:3]
            if mat_params.normal is not None:
                perturbed_nrm = tex2d.sample(mat_params.normal, gb_texc, uv_da)[..., 0:3]
            # smoothness taps one screen pixel away
            shift_t = draws.randint("tex_shift", (2,), -1, 2)
            grad_weight = mask * _roll(mask, shift_t)
            kd_grad = abs_tie_up(_roll(kd, shift_t) - kd) * grad_weight
            ks_grad = abs_tie_up(_roll(ks, shift_t) - ks) * omit_o * grad_weight
        else:
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
        gb_pos, view_pos, perturbed_nrm, gb_normal_smooth, gb_tangent, gb_geo_normal,
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
        with span("recon.shade"):
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
            with span("recon.denoise"):
                ds = bilateral_denoiser(ds, gb_normal, gb_depth, denoiser_sigma)
        diffuse_accum, specular_accum = ds[..., 0:3], ds[..., 3:6]

        if bsdf in ("white", "diffuse"):
            shaded_col = diffuse_accum * kd_eff
        else:
            shaded_col = diffuse_accum * (kd_eff * (1.0 - ks[..., 2:3])) + specular_accum
        if flags.use_denoiser and not flags.denoiser_demodulate:
            with span("recon.denoise"):
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
    if perturbed_nrm is not None:
        pn_grad = 1.0 - safe_normalize(
            safe_normalize(_roll(perturbed_nrm, shift)) + safe_normalize(perturbed_nrm))[..., 2:3]
        buffers["perturbed_nrm"] = torch.cat([perturbed_nrm, alpha], -1)
        buffers["perturbed_nrm_grad"] = torch.cat([pn_grad.expand_as(perturbed_nrm) * mask, alpha], -1)
    if msdf is not None:
        buffers["msdf_image"] = msdf_image
    if spp > 1:  # every image buffer back to the base resolution
        buffers = {k: avg_pool_nhwc(v[None], spp)[0] for k, v in buffers.items()}

    vis_vert = torch.zeros((verts.shape[0],), dtype=torch.bool, device=dev)
    vis_vert[faces[fid[rast.tri_id > 0]].reshape(-1)] = True
    buffers["visible_vert_mask"] = vis_vert
    buffers["n_raster_dropped"] = rast.dropped
    buffers["n_px_dropped"] = px_dropped
    if n_layers > 1:
        buffers["rast_second"] = layers[1] if spp == 1 else rasterize_layers(v_clip, faces, flags, 2)[1]
    return buffers


def render_second_layer(draws, verts, faces, v_nrm, mat_params: dict, mat_cfg: MLPTexture3DConfig, mvp, campos,
                        light: EnvLight, flags: RenderFlags, rast2, background=None,
                        visibility: ShadowField | SdfVisibility | None = None, shadow_scale: float = 0.0) -> dict:
    """The second-nearest surface of each pixel, shaded and composited (JAX
    ``render_second_layer`` :566, which peels its own raster): ``rast2`` is
    layer 2 of the view's peel (:func:`rasterize_layers`, or the
    ``rast_second`` of :func:`render_mesh` with ``n_layers=2``), interpolated
    position and normal, face normal, random tangents, the shading normal,
    foreground compaction under ``shade_budget``, the material (exact table
    gradients), MC env shading without the denoiser, composite and
    antialias on the layer-2 raster.  Draws: ``tangent`` and ``shade/...``
    (JAX's ``k_tng, k_shade = split(key)``).  → ``shaded_second`` (H, W, 4),
    ``invdepth_second`` (H, W, 2) and ``n_px_dropped_second``."""
    h, w = flags.resolution
    dev = verts.device
    v_clip = xfm_points(verts, mvp)
    mask = (rast2.tri_id > 0).float()[..., None]

    gb_pos = interpolate(verts, rast2, faces, v_clip=v_clip)
    gb_nrm = interpolate(v_nrm, rast2, faces, v_clip=v_clip)
    fid = torch.clamp(rast2.tri_id - 1, min=0)
    gb_geo = compute_face_normals(verts, faces)[fid] * mask
    noise = safe_normalize(draws.normal("tangent", gb_nrm.shape))
    gb_tangent = torch.linalg.cross(noise, gb_nrm)
    view_pos = campos.reshape(1, 1, 3).expand_as(gb_pos)
    gb_normal = bsdf_ops.prepare_shading_normal(
        gb_pos, view_pos, None, gb_nrm, gb_tangent, gb_geo, two_sided_shading=True, opengl=True,
    )
    p = h * w
    idx_c, px_dropped2 = _fg_compact_idx(rast2.tri_id, p, flags.shade_budget)
    if idx_c is not None:
        perm2, inv2, n_slots2 = idx_c
        packed = _PermuteCompact.apply(torch.cat([gb_pos, gb_normal, mask], -1).reshape(p, 7),
                                       perm2, inv2, n_slots2)
        pos_s, nrm_s, mask_s = packed[:, 0:3], packed[:, 3:6], packed[:, 6:7]
        view_s = campos.reshape(1, 3).expand_as(pos_s)
    else:
        pos_s, nrm_s = gb_pos.reshape(p, 3), gb_normal.reshape(p, 3)
        mask_s, view_s = mask.reshape(p, 1), view_pos.reshape(p, 3)
    tex_s = sample_mlp_texture(mat_params, mat_cfg, pos_s)
    kd_s, ks_s = tex_s[..., 0:3], tex_s[..., 3:6]
    out = env_shade(
        draws.child("shade"), mask_s, pos_s + nrm_s * 1e-3, pos_s, nrm_s, view_s, kd_s, ks_s, light,
        n_samples_x=flags.n_samples, bsdf=flags.bsdf, shadow_scale=shadow_scale, visibility=visibility,
        mc_block=flags.mc_block, light_bf16=flags.light_bf16,
    )
    shaded_rows = out.diffuse * (kd_s * (1.0 - ks_s[..., 2:3])) + out.specular
    if idx_c is not None:
        shaded = _PermuteScatter.apply(shaded_rows, perm2, inv2, p).reshape(h, w, 3)
    else:
        shaded = shaded_rows.reshape(h, w, 3)
    if background is None:
        background = torch.zeros((h, w, 3), device=dev)
    comp = background * (1.0 - mask) + shaded * mask
    shaded_aa = antialias(torch.cat([comp, mask], -1), rast2, v_clip, faces)
    dist = torch.sqrt(torch.clamp(torch.sum((gb_pos - view_pos) ** 2, -1, keepdim=True), min=1e-12))
    return {
        "shaded_second": shaded_aa,
        "invdepth_second": torch.cat([(1.0 / dist) * mask, torch.ones_like(mask)], -1),
        "n_px_dropped_second": px_dropped2,
    }


@torch.no_grad()
def render_uv(v_tex, t_tex_idx, v_pos, t_pos_idx, resolution, mat_params: dict, mat_cfg: MLPTexture3DConfig):
    """Bake the neural material into a UV atlas (JAX ``render_uv``): the mesh
    rasterized in UV space by the scan (clip x, y = 2·uv − 1, z = 0: the
    least face id wins where charts overlap), world positions interpolated
    through ``t_pos_idx``, the material sampled there.  Texels that no chart
    covers get the material at the origin, as JAX's do.  Row 0 is v = 0.
    → (mask (H, W, 1), kd (H, W, 3), ks (H, W, 3))."""
    uv_clip = v_tex * 2.0 - 1.0
    uv_clip4 = torch.cat([uv_clip, torch.zeros_like(uv_clip[..., :1]), torch.ones_like(uv_clip[..., :1])], dim=-1)
    rast = rasterize(uv_clip4, t_tex_idx, resolution, chunk=256)
    gb_pos = interpolate(v_pos, rast, t_pos_idx)
    all_tex = sample_mlp_texture(mat_params, mat_cfg, gb_pos)
    mask = (rast.tri_id > 0).float()[..., None]
    return mask, all_tex[..., 0:3], all_tex[..., 3:6]
