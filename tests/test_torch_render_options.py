"""``render_mesh``'s remaining options in the port against the JAX package,
on the CPU, with the JAX draws replayed by name: Texture2D materials (kd
with alpha, ks, with and without a normal map) under the ``pbr`` and ``kd``
BSDFs, supersampling (``spp`` 2), denoising after modulation
(``denoiser_demodulate: false``) and the ``normal`` / ``kd`` / ``ks``
BSDFs; and the tets tick with ``spp`` 2 and the second layer, which JAX
peels at the base resolution.

Each case renders a sphere (per-vertex spherical UVs, so that UV and
position faces coincide, ``tests/test_torch_bake.py``) at 32² (64² under
``spp`` 2), n_samples 2, and takes the gradient of a fixed random weighting
of every image buffer to the vertices, the normals, the material (every mip
level of every map, or the hash grid and the MLP) and the light.  JAX's
outputs are computed once per case in a module fixture.

Tolerances: buffers that no Monte-Carlo sample reaches (coverage,
material, normals, depth, and ``shaded`` under ``normal`` / ``kd`` / ``ks``)
rtol 1e-4 / atol 2e-5; each mip level's gradient under those BSDFs rtol
1e-3 / atol 3e-5 of its largest element; under ``pbr`` an MC sample may
flip on the frameworks' round-off, so the shaded and light buffers are held
by their mean and max difference, and every gradient group (vertices,
normals, material, light) by cosine and relative norm, at limits about 2×
off the CPU readings (``LIMITS``), as ``tests/test_torch_slice.py`` holds
the first layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_second_layer_ticks as ticks
import torch

import gshell_tpu_torch.geometry.geometry as tgeo
from gshell_tpu.geometry.geometry import GeometryConfig as JGeometryConfig
from gshell_tpu.geometry.geometry import GShellGeometry as JGShellGeometry
from gshell_tpu.geometry.mlp import MLPConfig as JMLPConfig
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.ops.image_loss import create_loss as j_create_loss
from gshell_tpu.ops.math import lookat, perspective
from gshell_tpu.render import texture as jtex
from gshell_tpu.render.light import EnvLight as JEnvLight
from gshell_tpu.render.light import create_trainable_env_rnd as j_env_rnd
from gshell_tpu.render.light import update_pdf as j_update_pdf
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu.render.render import render_mesh as j_render_mesh
from gshell_tpu_torch import convert
from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.geometry.mlp import MLPConfig
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.render.light import EnvLight, update_pdf
from gshell_tpu_torch.render.material import MLPTexture3DConfig
from gshell_tpu_torch.render.render import RenderFlags, render_mesh
from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
from gshell_tpu_torch.utils.rng import ReplayDraws
from gshell_tpu_torch.utils.synthetic_gt import sphere
from torch_parity import _draw, assert_close, cosine_and_norm, n, t, train_source, view_key_for

torch.set_num_threads(1)
RES = 32
HASH = dict(n_levels=4, log2_table_size=10, base_resolution=4, desired_resolution=32)
EXACT = ("mask", "kd", "ks", "kd_grad", "ks_grad", "normal_grad", "normal", "geometric_normal", "z_grad",
         "invdepth", "msdf_image", "perturbed_nrm", "perturbed_nrm_grad")
# material, normal map, bsdf, spp, denoiser_demodulate
CASES = {
    "texture+normal map, pbr": ("texture", True, "pbr", 1, True),
    "texture, kd": ("texture", False, "kd", 1, True),
    "texture+normal map, kd, spp 2": ("texture", True, "kd", 2, True),
    "texture, pbr, spp 2, modulated denoise": ("texture", False, "pbr", 2, False),
    "mlp, pbr, modulated denoise": ("mlp", False, "pbr", 1, False),
    "mlp, normal": ("mlp", False, "normal", 1, True),
    "mlp, ks, spp 2": ("mlp", False, "ks", 2, True),
}
# Readings on the CPU (worst over the cases): under pbr the shaded and light
# buffers mean |diff| 1.16e-6, max 3.10e-3 (one MC sample of the specular
# light under spp 2 and the modulated denoise); gradients (1 − cosine,
# relative norm difference) under pbr verts 5.0e-8 2.4e-5, normals 8.5e-9
# 1.28e-5, material 1.7e-9 3.9e-7, light 1.23e-5 1.96e-5; under normal / kd /
# ks verts 1.6e-8 2.4e-5, normals 2.3e-11 5.1e-7, material 2.8e-11 5.4e-7.
# Limits about 2x off.
LIMITS = {
    "buffers": (2.4e-6, 6.2e-3),  # mean |diff| ≤, max |diff| ≤
    "pbr": {"verts": (1 - 1e-7, 4.8e-5), "normals": (1 - 1.7e-8, 2.6e-5), "material": (1 - 3.4e-9, 7.8e-7),
            "light": (1 - 2.5e-5, 3.9e-5)},  # cosine ≥, relative norm difference ≤
    "exact": {"verts": (1 - 3.2e-8, 4.8e-5), "normals": (1 - 4.6e-11, 1e-6), "material": (1 - 5.6e-11, 1.1e-6)},
}


def _scene():
    v, f = sphere(16, 10)
    v = (v * 0.8).astype(np.float32)
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    uv = np.stack([0.5 + np.arctan2(unit[:, 0], unit[:, 2]) / (2 * np.pi), np.arccos(np.clip(unit[:, 1], -1, 1)) / np.pi],
                  -1).astype(np.float32)
    msdf = (0.3 - unit[:, 1]).astype(np.float32)
    eye = np.float32([0.3, 0.5, 2.2])
    mvp = np.asarray(perspective(np.deg2rad(45.0)) @ lookat(jnp.asarray(eye), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])))
    return v, f.astype(np.int32), unit.astype(np.float32), uv, msdf, mvp, eye


def _textures(normal_map):
    """Smooth maps in [0, 1] with no flat region: neighbouring pixels never
    sample equal values, so no |Δ| of the smoothness taps sits at 0, where
    the sign of a rounding difference would pick its derivative."""
    rng = np.random.default_rng(1)
    yx = np.stack(np.meshgrid(np.arange(32), np.arange(32), indexing="ij"), -1) / 32.0

    def smooth(c):
        freq, phase = rng.uniform(1.0, 3.0, size=(c, 2)), rng.uniform(0, 2 * np.pi, size=c)
        return 0.5 + 0.45 * np.sin(2 * np.pi * (yx @ freq.T) + phase)
    kd = np.concatenate([smooth(3), 0.6 + 0.4 * smooth(1)], -1)
    ks = np.concatenate([np.zeros((32, 32, 1)), 0.4 + 0.6 * smooth(1), smooth(1)], -1)
    maps = {"kd": jtex.build_mips(jnp.asarray(kd, jnp.float32)), "ks": jtex.build_mips(jnp.asarray(ks, jnp.float32))}
    if normal_map:
        nm = np.concatenate([0.35 + 0.3 * smooth(2), np.ones((32, 32, 1))], -1)
        maps["normal"] = jtex.build_mips(jnp.asarray(nm, jnp.float32))
    return maps


@pytest.fixture(scope="module")
def common():
    mat_j = JMatConfig(channels=6, internal_dims=16, hidden=2, hash=JHashGridConfig(**HASH),
                       min_max=default_kd_ks_min_max())
    mat_t = MLPTexture3DConfig(channels=6, internal_dims=16, hidden=2, hash=HashGridConfig(**HASH),
                               min_max=default_kd_ks_min_max())
    params_j = init_mlp_texture(jax.random.PRNGKey(43), mat_j)
    tables = np.random.default_rng(2).uniform(-0.5, 0.5, size=np.asarray(params_j.tables.tables).shape)
    params_j = params_j._replace(tables=params_j.tables._replace(tables=jnp.asarray(tables, jnp.float32)))
    return mat_j, mat_t, params_j, j_env_rnd(jax.random.PRNGKey(42), 32)


def _weights(shapes):
    rng = np.random.default_rng(3)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sorted(shapes.items())}


@pytest.fixture(scope="module", params=list(CASES))
def rendered(request, common):
    kind, normal_map, bsdf, spp, demod = CASES[request.param]
    mat_j, mat_t, params_j, light_j = common
    v, f, nrm, uv, msdf, mvp, eye = _scene()
    key = jax.random.PRNGKey(9)
    kw = dict(resolution=(RES, RES), n_samples=2, bsdf=bsdf, spp=spp, denoiser_demodulate=demod, mc_block=2)
    bg = np.random.default_rng(4).uniform(size=(RES, RES, 3)).astype(np.float32)
    mat_params_j = _textures(normal_map) if kind == "texture" else params_j
    uv_kw = dict(v_tex=jnp.asarray(uv), t_tex_idx=jnp.asarray(f)) if kind == "texture" else {}

    def render_j(verts, normals, mat, light_base):
        light = JEnvLight(base=light_base, pdf=light_j.pdf, rows=light_j.rows, cols=light_j.cols)
        return j_render_mesh(key, verts, jnp.asarray(f), normals, jnp.asarray(msdf), mat, mat_j, jnp.asarray(mvp),
                             jnp.asarray(eye), light, JRenderFlags(raster_backend="xla", max_per_tile=4096, **kw),
                             background=jnp.asarray(bg), shadow_scale=0.0, **uv_kw)

    shapes = {k: o.shape for k, o in jax.eval_shape(render_j, jnp.asarray(v), jnp.asarray(nrm), mat_params_j,
                                                     light_j.base).items()
              if len(o.shape) == 3}
    weights = _weights(shapes)

    def loss_j(*args):
        out = render_j(*args)
        return sum(jnp.sum(out[k] * w) for k, w in weights.items()), out

    (loss_jv, out_j), grads_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(v), jnp.asarray(nrm), mat_params_j, light_j.base)

    vt, nt = t(v, True), t(nrm, True)
    if kind == "texture":
        mat_t_params = convert.texture_material_from_jax(mat_params_j, "cpu")
        mat_leaves = [m.requires_grad_(True) for tex in mat_t_params if tex is not None for m in tex.mips]
        uv_t = dict(v_tex=t(uv), t_tex_idx=t(f).long())
    else:
        mat_t_params = convert.params_mat_from_jax(params_j, "cpu")
        mat_leaves = [mat_t_params["tables"].requires_grad_(True)] + [w.requires_grad_(True) for w in mat_t_params["mlp"]]
        uv_t = {}
    base_t = t(np.asarray(light_j.base), True)
    light_t = EnvLight(base=base_t, pdf=t(light_j.pdf), rows=t(light_j.rows), cols=t(light_j.cols))
    draws = ReplayDraws(lambda kind_, name, shape, lo, hi: _draw(kind_, view_key_for(key, name), shape, lo, hi))
    out_t = render_mesh(draws, vt, t(f).long(), nt, t(msdf), mat_t_params, mat_t, t(mvp), t(eye), light_t,
                        RenderFlags(**kw), background=t(bg), shadow_scale=0.0, **uv_t)
    loss_t = sum(torch.sum(out_t[k] * t(w)) for k, w in weights.items())
    loss_t.backward()
    g_v, g_n, g_m, g_l = grads_j
    if kind == "texture":
        g_mat_j = np.concatenate([np.asarray(m).reshape(-1) for name in ("kd", "ks", "normal") if name in g_m
                                  for m in g_m[name].mips])
    else:
        g_mat_j = np.concatenate([np.asarray(g_m.tables.tables).reshape(-1)]
                                 + [np.asarray(w).reshape(-1) for w in g_m.mlp])
    g_mat_t = torch.cat([(torch.zeros_like(x) if x.grad is None else x.grad).reshape(-1) for x in mat_leaves])
    grads = {"verts": (vt.grad, g_v), "normals": (nt.grad, g_n), "material": (g_mat_t, g_mat_j),
             "light": (base_t.grad, g_l)}
    if kind == "texture":  # each mip level of each map on its own
        level_t = [x.grad for x in mat_leaves]
        level_j = [m for name in ("kd", "ks", "normal") if name in g_m for m in g_m[name].mips]
        grads["levels"] = (level_t, level_j)
    return request.param, out_j, out_t, grads


def test_render_options_buffers_match_jax(rendered):
    case, out_j, out_t, _ = rendered
    kind, normal_map, bsdf, spp, demod = CASES[case]
    assert sorted(out_t) == sorted(out_j), case
    assert ("diffuse_light" in out_t) == (bsdf == "pbr")
    assert ("perturbed_nrm" in out_t) == normal_map
    assert out_t["shaded"].shape == (RES, RES, 4)
    mask = n(out_t["mask"])
    np.testing.assert_array_equal(np.asarray(out_j["visible_vert_mask"]), n(out_t["visible_vert_mask"]))
    assert 100 < (mask[..., 0] > 0).sum() < RES * RES
    if spp > 1:
        assert ((mask > 0) & (mask < 1)).any(), "the pooled silhouette is fractional"
    exact = [k for k in EXACT if k in out_t] + ([] if bsdf == "pbr" else ["shaded"])
    for k in exact:
        assert_close(out_t[k], out_j[k], rtol=1e-4, atol=2e-5, what=f"{case}: {k}")
    if bsdf == "pbr":
        mean_lim, max_lim = LIMITS["buffers"]
        for k in ("shaded", "diffuse_light", "specular_light"):
            err = np.abs(n(out_t[k]).astype(np.float64) - np.asarray(out_j[k]))
            assert err.mean() <= mean_lim and err.max() <= max_lim, (case, k, err.mean(), err.max())
            assert np.abs(np.asarray(out_j[k])[..., :3]).max() > 0


def test_render_options_gradients_match_jax(rendered):
    case, _, _, grads = rendered
    bsdf = CASES[case][2]
    shading = bsdf == "pbr"
    level_t, level_j = grads.get("levels", ((), ()))
    for k, (gt, gj) in enumerate(zip(level_t, level_j)):
        gj = np.asarray(gj)
        assert np.abs(n(gt)).max() > 0, f"{case}: mip level {k} got no gradient"
        if not shading:
            assert_close(gt, gj, rtol=1e-3, atol=3e-5 * np.abs(gj).max(), what=f"{case}: mip level {k}")
    for what in ("verts", "normals", "material", "light"):
        gt, gj = grads[what]
        gj = np.asarray(gj)
        if what == "light" and not shading:  # no light reaches a normal / kd / ks image
            assert gt is None and not gj.any(), case
            continue
        assert np.abs(gj).max() > 0, (case, what)
        cos, dn = cosine_and_norm(gt, gj)
        lim = LIMITS["pbr" if shading else "exact"][what]
        assert cos >= lim[0] and dn <= lim[1], (case, what, cos, dn)


# The tets tick with spp 2 and the second layer: grid 12, 32² (64² rasters),
# batch 2, mesh-splat shadows, ``map_remat``, state step 1000, the pretrained
# sphere cut open as in ``tests/test_torch_second_layer_ticks.py``.  Readings
# on the CPU: relative loss differences total 3.7e-4, img 4.1e-4, reg 3.9e-7;
# gradients (1 − cosine, relative norm difference) deform .0150 .094, msdf
# 2.2e-6 6.6e-4, sdf_net .0094 .164, tables .00108 .0045, mlp 1.3e-4 5.0e-4,
# light .0165 .00105.  MC samples that flip on round-off, four times as many
# pixels as at spp 1, and the undenoised second layer keeps its flips: at
# spp 1 the same tick reads img 4.0e-4, deform .0162 .036; at spp 2 without
# the second layer img 3.8e-5, deform .0026 .175.  Limits about 2x off.
TICK_RES = 32
TICK_LOSS_RTOL = {"total": 7.4e-4, "img": 8.2e-4, "reg": 8e-7}
TICK_LIMITS = {"deform": (0.970, 0.19), "msdf": (1 - 4.4e-6, 1.3e-3), "sdf_net": (0.981, 0.33),
               "tables": (0.9978, 0.009), "mlp": (0.99974, 1e-3), "light": (0.967, 0.0021)}


def test_tets_tick_with_spp2_peels_the_second_layer_at_base_resolution(monkeypatch):
    """JAX's ``render_second_layer`` peels at the base resolution whatever
    the spp; the port's tick, given ``spp`` 2, rasterizes each view again
    at the base resolution for the second layer.  Losses and gradients as
    JAX's, and the second layer's images are 32², not 64²."""
    geo_kw = dict(grid_res=12, n_eikonal_samples=512, total_iters=5000, use_img_2nd_layer=True)
    mat_kw = dict(channels=6, internal_dims=16, hidden=2, min_max=default_kd_ks_min_max())
    flags_kw = dict(resolution=(TICK_RES, TICK_RES), n_samples=2, spp=2, mc_block=2)
    hash_kw = dict(n_levels=4, log2_table_size=12, base_resolution=4, desired_resolution=64)
    geo_j = JGShellGeometry(JGeometryConfig(mlp=JMLPConfig(**ticks.MLP), view_batch_mode="map_remat", **geo_kw))
    params = ticks._cut(geo_j.pretrain_sdf(geo_j.init_params(jax.random.PRNGKey(0)), steps=300),
                        np.asarray(geo_j.verts))
    mat_j = JMatConfig(hash=JHashGridConfig(**hash_kw), **mat_kw)
    state_j = {"geo": params, "mat": init_mlp_texture(jax.random.PRNGKey(1), mat_j),
               "light": jnp.asarray(ticks._smooth_light())}
    rng = np.random.default_rng(6)
    ys, xs = np.meshgrid(np.arange(TICK_RES), np.arange(TICK_RES), indexing="ij")
    r = np.hypot(xs - TICK_RES / 2, ys - TICK_RES / 2)[..., None]
    disk = lambda rad, c: np.concatenate([np.repeat(c * (r < rad), 3, -1), r < rad], -1).astype(np.float32)
    views = ticks._target()
    target = {"mvp": views["mvp"], "campos": views["campos"],
              "img": np.stack([disk(0.3 * TICK_RES, 0.5)] * 2), "img_second": np.stack([disk(0.2 * TICK_RES, 0.3)] * 2),
              "background": rng.uniform(size=(2, TICK_RES, TICK_RES, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    jflags = JRenderFlags(raster_backend="xla", max_per_tile=4096, **flags_kw)

    def loss_fn(pg, pm, lb):
        img, depth, reg, aux = geo_j.tick(key, pg, pm, mat_j, j_update_pdf(lb), {k: jnp.asarray(v) for k, v in target.items()},
                                          1000, jflags, j_create_loss("logl1"), visibility_fn="mesh_splat",
                                          shadow_scale=1.0, denoiser_sigma=2.0, shadow_ko=16)
        return img + depth + reg, (img, reg, aux)

    (total_j, (img_j, reg_j, aux_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True))(
        state_j["geo"], state_j["mat"], state_j["light"])

    geo = GShellGeometry(GeometryConfig(mlp=MLPConfig(**ticks.MLP), view_batch_mode="map_remat", **geo_kw), "cpu")
    rec = Reconstructor(geo, MLPTexture3DConfig(hash=HashGridConfig(**hash_kw), **mat_kw), RenderFlags(**flags_kw),
                        TrainConfig(batch=2))
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)
    st = convert.state_from_jax(rec, tree(state_j["geo"]), tree(state_j["mat"]), np.asarray(state_j["light"]), step=1000)
    seen, render_second = [], tgeo.render_second_layer

    def spy(*args, rast2, **kw):
        out = render_second(*args, rast2=rast2, **kw)
        seen.append((tuple(rast2.tri_id.shape), tuple(out["shaded_second"].shape[:2])))
        return out

    monkeypatch.setattr(tgeo, "render_second_layer", spy)
    img, depth, reg, aux = geo.tick(ReplayDraws(train_source(key, 2)), st.params_geo, st.params_mat, rec.mat_cfg,
                                    update_pdf(st.light_base), {k: t(v) for k, v in target.items()}, 1000,
                                    rec.flags, rec.image_loss_fn, use_shadows=True, shadow_scale=1.0,
                                    denoiser_sigma=2.0)
    (img + depth + reg).backward()
    assert len(seen) >= 2 and set(seen) == {((TICK_RES, TICK_RES), (TICK_RES, TICK_RES))}, seen
    assert int(aux["n_faces"]) == int(aux_j["n_faces"]) > 0
    for what, a, b in (("total", img + depth + reg, total_j), ("img", img, img_j), ("reg", reg, reg_j)):
        assert_close(a, b, rtol=TICK_LOSS_RTOL[what], what=what)
    gt, gj = ticks._grads_port(st), ticks._grads_jax(grads_j)
    for g in TICK_LIMITS:
        cos, dn = cosine_and_norm(gt[g], gj[g])
        assert np.abs(n(gt[g])).max() > 0, g
        assert cos >= TICK_LIMITS[g][0] and dn <= TICK_LIMITS[g][1], (g, cos, dn)
