"""The second surface layer and the depth supervision of the port against
the JAX package, on the CPU, and the per-view recomputation of the ticks.

* ``render_second_layer`` against JAX's with the JAX draws replayed (JAX
  splits the view key into ``k_tng, k_shade``; the port draws ``tangent``
  and ``shade/...``), at 48² on two nested spheres, with and without
  foreground compaction: the layer-2 coverage is equal and its inverse depth
  within rtol 1e-4; the shaded image, a weighted loss of it and the
  gradients to vertices, normals and the material are held like the first
  layer's (``tests/test_torch_dataset_mesh.py``, ``tests/test_torch_slice.py``):
  a few Monte-Carlo samples flip on round-off, so the image by its mean and
  max difference and the pixels off, each gradient by cosine and relative
  norm, at limits ~1.5x off the readings (taken on an earlier test host, its
  CPU model not recorded).  Both sides render from JAX's clip
  positions (``torch_parity.clip_from_jax``) and JAX runs un-jitted: on an
  "AMD EPYC" host jitted JAX (XLA fuses and contracts the shade) took
  another Monte-Carlo branch than its own un-jitted evaluation on a 2×2
  block of pixels (42–43, 23–24), 0.030 / 0.069 off (full / compacted),
  where the port follows the un-jitted one.  The port peels with stage B's
  two layers over the tile segments, JAX with its scan.
* ``second_layer_and_depth_losses`` against JAX's: every flag combination,
  with and without the supervision in the target (the guards), values and
  gradients.
* ``DatasetMesh(layers=2)`` against JAX's on a small skirt (open at both
  ends), shadowed: the
  first layer, its inverse depth and the second layer's image and inverse
  depth, at limits ~1.5× off the readings (``LIMITS``), as
  ``tests/test_torch_dataset_mesh.py`` holds the first layer.
* ``view_batch_mode``: the tets and the FlexiCubes ticks under ``map`` and
  ``map_remat`` (each view recomputed in the backward under the latter
  only), with the second layer and depth on, from one ``torch.Generator``:
  the losses, every gradient and the generator's state after the backward
  are equal bit for bit (PyTorch's deterministic algorithms on, as the
  CPU's multi-threaded index accumulation otherwise is not).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gshell_tpu_torch.render.render as trender

from gshell_tpu.data.datasets import DatasetMesh as JDatasetMesh
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.ops.image_loss import create_loss as j_create_loss
from gshell_tpu.ops.math import lookat, perspective
from gshell_tpu.render import regularizer as jreg
from gshell_tpu.render.light import create_trainable_env_rnd as j_env_rnd
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
from gshell_tpu.render.mesh import load_obj as j_load_obj
from gshell_tpu.render.mesh import unit_size as j_unit_size
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu.render.render import render_second_layer as j_render_second_layer
from gshell_tpu_torch import convert
from gshell_tpu_torch.data.datasets import DatasetMesh
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.ops.image_loss import create_loss
from gshell_tpu_torch.render import regularizer as treg
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.render.material import MLPTexture3DConfig
from gshell_tpu_torch.render.mesh import load_obj, unit_size
from gshell_tpu_torch.render.render import RenderFlags, rasterize_layers, render_second_layer
from gshell_tpu_torch.utils.rng import ReplayDraws, TorchDraws
from gshell_tpu_torch.utils.synthetic_gt import sphere
from torch_parity import _draw, assert_close, clip_from_jax, cosine_and_norm, n, second_key_for, t, view_key_for

torch.set_num_threads(1)
RES = 48
HASH = dict(n_levels=4, log2_table_size=10)


def _scene():
    v, f = sphere(16, 10)
    verts = np.concatenate([v * 0.8, v * 0.45 + np.float32([0.1, 0.0, 0.1])]).astype(np.float32)
    faces = np.concatenate([f, f + len(v)]).astype(np.int32)
    nrm = (verts / np.linalg.norm(verts, axis=-1, keepdims=True)).astype(np.float32)
    mvp = np.asarray(perspective(np.deg2rad(45.0)) @ lookat(
        jnp.array([0.3, 0.4, 2.2]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])))
    return verts, faces, nrm, mvp, np.float32([0.3, 0.4, 2.2])


@pytest.fixture(scope="module")
def material():
    mat_j = JMatConfig(channels=6, hash=JHashGridConfig(**HASH), min_max=default_kd_ks_min_max())
    mat_t = MLPTexture3DConfig(channels=6, hash=HashGridConfig(**HASH), min_max=default_kd_ks_min_max())
    params_j = init_mlp_texture(jax.random.PRNGKey(43), mat_j)
    light_j = j_env_rnd(jax.random.PRNGKey(42), 32)
    return mat_j, mat_t, params_j, light_j


# Readings on the CPU (full / compacted): shaded_second mean |diff| 4.9e-6 /
# 8.2e-6, max 0.0123 / 0.0322, 2 / 2 pixels off by > 1e-3 (Monte-Carlo
# samples that flip on the two frameworks' round-off; no denoiser spreads
# them here); the weighted loss 6.9e-4 / 1.9e-3 relative; gradient cosine and
# relative norm difference verts .999956 2.8e-4 / .999958 1.5e-4, normals
# .99938 2.3e-3 / .99756 6.2e-4, tables .99898 1.4e-4 / .99880 2.1e-4, mlp
# .99973 8.5e-4 / .99966 9.8e-4.  Limits about 1.5x off.
SECOND_SHADED_LIMITS = (1.25e-5, 0.05, 3)
SECOND_LOSS_RTOL = 3e-3
SECOND_GRAD_LIMITS = {"verts": (0.99993, 4.2e-4), "normals": (0.99634, 3.4e-3), "tables": (0.9982, 3.2e-4),
                      "mlp": (0.9995, 1.5e-3)}


@pytest.mark.parametrize("shade_budget", [None, 0.5], ids=["full", "compacted"])
def test_render_second_layer_matches_jax(material, shade_budget):
    mat_j, mat_t, params_j, light_j = material
    verts, faces, nrm, mvp, campos = _scene()
    key = jax.random.PRNGKey(9)
    kw = dict(resolution=(RES, RES), n_samples=2, shade_budget=shade_budget)
    rng = np.random.default_rng(0)
    bg = rng.uniform(size=(RES, RES, 3)).astype(np.float32)
    g_sh = rng.normal(size=(RES, RES, 4)).astype(np.float32)
    g_id = rng.normal(size=(RES, RES, 2)).astype(np.float32)

    def fj(v, nr, pm):
        out = j_render_second_layer(key, v, jnp.asarray(faces), nr, pm, mat_j, jnp.asarray(mvp),
                                    jnp.asarray(campos), light_j, JRenderFlags(**kw), background=jnp.asarray(bg))
        loss = jnp.sum(out["shaded_second"] * g_sh) + jnp.sum(out["invdepth_second"] * g_id)
        return loss, out

    # un-jitted, and both sides from JAX's clip positions (the module docstring)
    (loss_j, out_j), grads_j = jax.value_and_grad(fj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(nrm), params_j)

    params_t = convert.params_mat_from_jax(params_j, "cpu")
    params_t = {"tables": params_t["tables"].requires_grad_(True),
                "mlp": [w.requires_grad_(True) for w in params_t["mlp"]]}
    vt, nt = t(verts, True), t(nrm, True)
    draws = ReplayDraws(lambda kind, name, shape, lo, hi: _draw(kind, second_key_for(key, name), shape, lo, hi))
    flags = RenderFlags(**kw)
    with torch.no_grad():
        rast2 = rasterize_layers(clip_from_jax(t(verts), t(mvp)), t(faces).long(), flags, 2)[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trender, "xfm_points", clip_from_jax)
        out_t = render_second_layer(draws, vt, t(faces).long(), nt, params_t, mat_t, t(mvp), t(campos),
                                    update_pdf(torch.as_tensor(np.array(light_j.base))), flags, rast2,
                                    background=t(bg))
    loss_t = torch.sum(out_t["shaded_second"] * t(g_sh)) + torch.sum(out_t["invdepth_second"] * t(g_id))
    loss_t.backward()

    mask = n(out_t["invdepth_second"])[..., 0] > 0
    np.testing.assert_array_equal(mask, np.asarray(out_j["invdepth_second"])[..., 0] > 0)
    assert mask.sum() > 300, "the inner sphere shows through the outer one"
    assert int(out_t["n_px_dropped_second"]) == int(out_j["n_px_dropped_second"])
    assert set(out_t) == set(out_j)
    assert_close(out_t["invdepth_second"], out_j["invdepth_second"], rtol=1e-4, atol=1e-5, what="invdepth_second")
    err = np.abs(n(out_t["shaded_second"]).astype(np.float64) - np.asarray(out_j["shaded_second"]))
    mean_lim, max_lim, n_lim = SECOND_SHADED_LIMITS
    n_off = int((err.max(-1) > 1e-3).sum())
    assert err.mean() <= mean_lim and err.max() <= max_lim and n_off <= n_lim, (err.mean(), err.max(), n_off)
    assert_close(loss_t, loss_j, rtol=SECOND_LOSS_RTOL, what="loss")
    g_v, g_n, g_m = grads_j
    for what, gt, gj in (("verts", vt.grad, g_v), ("normals", nt.grad, g_n),
                         ("tables", params_t["tables"].grad, g_m.tables.tables),
                         ("mlp", torch.cat([w.grad.reshape(-1) for w in params_t["mlp"]]),
                          np.concatenate([np.asarray(w).reshape(-1) for w in g_m.mlp]))):
        assert np.abs(np.asarray(gj)).max() > 0, what
        cos, dn = cosine_and_norm(gt, gj)
        assert cos >= SECOND_GRAD_LIMITS[what][0] and dn <= SECOND_GRAD_LIMITS[what][1], (what, cos, dn)


FLAG_SETS = [
    dict(use_depth=True, use_img_2nd_layer=True, use_depth_2nd_layer=True),
    dict(use_depth=True, use_img_2nd_layer=False, use_depth_2nd_layer=False),
    dict(use_depth=False, use_img_2nd_layer=True, use_depth_2nd_layer=True),
    dict(use_depth=True, use_img_2nd_layer=False, use_depth_2nd_layer=True),
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["all", "depth", "img2+depth2 only", "depth+depth2"])
@pytest.mark.parametrize("supervised", [True, False], ids=["target", "no target"])
def test_second_layer_and_depth_losses_match_jax(flags, supervised):
    rng = np.random.default_rng(1)
    shp = (2, 16, 16)
    bufs = {"shaded": rng.uniform(size=shp + (4,)), "shaded_second": rng.uniform(size=shp + (4,)),
            "invdepth": rng.uniform(size=shp + (2,)), "invdepth_second": rng.uniform(size=shp + (2,))}
    bufs = {k: v.astype(np.float32) for k, v in bufs.items()}
    bufs["invdepth"][0, :4, :4, 0] = 0.0  # ties with the target: |·|' = +1 at 0, as jnp.abs
    target = {"img": rng.uniform(size=shp + (4,)).astype(np.float32)}
    if supervised:
        mask = (rng.uniform(size=shp + (1,)) > 0.4).astype(np.float32)
        target.update(img_second=np.concatenate([rng.uniform(size=shp + (3,)) * mask, mask], -1).astype(np.float32),
                      invdepth=rng.uniform(size=shp + (1,)).astype(np.float32),
                      invdepth_second=rng.uniform(size=shp + (1,)).astype(np.float32))
        target["invdepth"][0, :4, :4, 0] = 0.0
    cfg = types.SimpleNamespace(**flags)
    keys = ("shaded_second", "invdepth", "invdepth_second")

    def fj(*xs):
        b = {**{k: jnp.asarray(v) for k, v in bufs.items()}, **dict(zip(keys, xs))}
        extra, depth = jreg.second_layer_and_depth_losses(cfg, b, {k: jnp.asarray(v) for k, v in target.items()},
                                                          j_create_loss("logl1"))
        return extra + depth, (extra, depth)

    (_, (extra_j, depth_j)), g_j = jax.value_and_grad(fj, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(bufs[k]) for k in keys))
    leaves = {k: t(bufs[k], True) for k in keys}
    extra_t, depth_t = treg.second_layer_and_depth_losses(
        cfg, {**{k: t(v) for k, v in bufs.items()}, **leaves}, {k: t(v) for k, v in target.items()},
        create_loss("logl1"))
    assert_close(extra_t, extra_j, rtol=1e-6, atol=1e-7, what="img_extra")
    assert_close(depth_t, depth_j, rtol=1e-6, atol=1e-7, what="depth_loss")
    if not supervised:
        assert float(extra_t) == float(depth_t) == 0.0
        return
    (extra_t + depth_t).backward()
    for k, gj in zip(keys, g_j):
        got = leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k])
        assert_close(got, gj, rtol=1e-5, atol=1e-9, what=f"d/d{k}")


# (mean |diff|, max |diff|, pixels off by > 1e-3) of the RGBA images, first
# and second layer; readings: see test_dataset_mesh_two_layers_match_jax
LIMITS = {"img": (2.1e-5, 0.12, 9), "img_second": (3e-5, 0.37, 8)}


def _gt_source(kind, name, shape, lo, hi):
    """Replay of the JAX DatasetMesh's draws: PRNGKey(191) for the splat,
    PRNGKey(i) for view i and, split in two, for its second layer."""
    top, _, rest = name.partition("/")
    if top == "splat":
        k_face, k_uv = jax.random.split(jax.random.PRNGKey(191))
        key = k_face if rest == "face" else k_uv
    else:
        key = view_key_for(jax.random.PRNGKey(int(top[len("view"):])), rest)
    return _draw(kind, key, shape, lo, hi)


def test_dataset_mesh_two_layers_match_jax(material, tmp_path):
    from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj

    """Readings on the CPU (img, img_second): mean |diff| 1.39e-5 / 1.99e-5,
    max 0.078 / 0.244, pixels off by > 1e-3 6 / 5 (a Monte-Carlo sample that
    flips on round-off moves a pixel by up to half its value at n_samples 2;
    the second layer has no denoiser).  Coverage is identical in both
    layers; the inverse depths agree to rtol 1e-5 but at one pixel (8.8e-4
    relative: stage B and JAX's XLA stage B pick neighbouring triangles on
    a shared edge), held to ≤ 2 such pixels within 1.5e-3."""
    mat_j, mat_t, params_j, light_j = material
    path = str(tmp_path / "skirt.obj")
    write_obj(path, *skirt(24, 12))
    kw = dict(n_views=2, seed=0, cam_radius=2.5, shadows=True, shadow_grid_res=33, layers=2)  # two side views
    flags = dict(resolution=(RES, RES), n_samples=2, bsdf="pbr", use_denoiser=True)
    ds_j = JDatasetMesh(j_unit_size(j_load_obj(path)), light_j, params_j, mat_j,
                        JRenderFlags(raster_backend="xla", max_per_tile=4096, **flags), **kw)
    ds_t = DatasetMesh(unit_size(load_obj(path)), update_pdf(torch.as_tensor(np.array(light_j.base))),
                       convert.params_mat_from_jax(params_j, "cpu"), mat_t, RenderFlags(**flags),
                       draws=ReplayDraws(_gt_source), **kw)
    assert ds_t.imgs_second.shape == (2, RES, RES, 4) and ds_t.invdepths_second.shape == (2, RES, RES, 1)
    second_fg = np.asarray(ds_j.imgs_second)[..., 3] > 0.5
    assert second_fg.mean() > 0.05, "the skirt's inside shows behind its front"
    for key, attr in (("img", "imgs"), ("img_second", "imgs_second")):
        a, b = n(getattr(ds_t, attr)).astype(np.float64), np.asarray(getattr(ds_j, attr), np.float64)
        err = np.abs(a - b)
        mean_lim, max_lim, n_lim = LIMITS[key]
        n_off = int((err.max(-1) > 1e-3).sum())
        assert err.mean() <= mean_lim and err.max() <= max_lim and n_off <= n_lim, (key, err.mean(), err.max(), n_off)
    for attr in ("invdepths", "invdepths_second"):
        a, b = n(getattr(ds_t, attr)).astype(np.float64), np.asarray(getattr(ds_j, attr), np.float64)
        np.testing.assert_array_equal(a > 0, b > 0)
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
        assert (rel > 1e-5).sum() <= 2 and rel.max() <= 1.5e-3, (attr, int((rel > 1e-5).sum()), rel.max())
    batch = ds_t.batch(np.array([1, 0]), background="white", rng=np.random.default_rng(0))
    assert set(batch) >= {"invdepth", "img_second", "invdepth_second"}
    np.testing.assert_array_equal(n(batch["img_second"]), n(ds_t.imgs_second[[1, 0]]))


# ---------------- view_batch_mode: map against map_remat ----------------

def _tiny_target(res, batch=2):
    from gshell_tpu_torch.ops import math as gm

    proj = gm.perspective(np.deg2rad(45.0), 1.0, 0.1, 1000.0)
    mvps, campos = [], []
    for eye in ([0.0, 0.3, 2.5], [1.8, 0.5, 1.6])[:batch]:
        eye_t = torch.tensor(eye)
        mvps.append(proj @ gm.lookat(eye_t, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0])))
        campos.append(eye_t)
    ys, xs = torch.meshgrid(torch.arange(res), torch.arange(res), indexing="ij")
    mask = ((xs - res / 2) ** 2 + (ys - res / 2) ** 2 < (0.3 * res) ** 2).float()[None, ..., None].repeat(batch, 1, 1, 1)
    inner = ((xs - res / 2) ** 2 + (ys - res / 2) ** 2 < (0.15 * res) ** 2).float()[None, ..., None].repeat(batch, 1, 1, 1)
    return {"mvp": torch.stack(mvps), "campos": torch.stack(campos),
            "img": torch.cat([0.5 * mask.repeat(1, 1, 1, 3), mask], -1),
            "background": torch.zeros((batch, res, res, 3)),
            "invdepth": 0.4 * mask, "img_second": torch.cat([0.3 * inner.repeat(1, 1, 1, 3), inner], -1),
            "invdepth_second": 0.35 * inner}


def _tick_grads(geo, rec, state, seed):
    gen = torch.Generator().manual_seed(seed)
    target = _tiny_target(32)
    img, depth, reg, aux = geo.tick(TorchDraws(gen), state.params_geo, state.params_mat, rec.mat_cfg,
                                    update_pdf(state.light_base), target, 1000, rec.flags, rec.image_loss_fn,
                                    use_shadows=True, shadow_scale=1.0, denoiser_sigma=2.0)
    for opt in state.optimizers:
        opt.zero_grad(set_to_none=True)
    (img + depth + reg).backward()
    leaves = [p for o in state.optimizers for g in o.param_groups for p in g["params"]]
    return ([x.detach().clone() for x in (img, depth, reg)], [p.grad.clone() for p in leaves],
            gen.get_state(), aux)


def _port_rec(flexi: bool, mode: str):
    from gshell_tpu_torch.geometry.flexi_geometry import FlexiGeometryConfig, GShellFlexiGeometry
    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.geometry.mlp import MLPConfig
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig

    kw = dict(grid_res=10 if flexi else 12, mlp=MLPConfig(n_freq=4, d_hidden=32, n_hidden=2, skip_in=(1,)),
              n_eikonal_samples=256, use_depth=True, use_img_2nd_layer=True, use_depth_2nd_layer=True,
              view_batch_mode=mode)
    geo = GShellFlexiGeometry(FlexiGeometryConfig(**kw), "cpu") if flexi else GShellGeometry(GeometryConfig(**kw), "cpu")
    mat = MLPTexture3DConfig(hash=HashGridConfig(n_levels=4, log2_table_size=10), internal_dims=16,
                             min_max=default_kd_ks_min_max())
    flags = RenderFlags(resolution=(32, 32), n_samples=2, mc_block=2, shade_budget=0.5, use_denoiser=True)
    return Reconstructor(geo, mat, flags, TrainConfig(batch=2))


@pytest.mark.parametrize("flexi", [False, True], ids=["tets", "flexicubes"])
def test_map_remat_equals_map_bit_for_bit(flexi):
    from gshell_tpu_torch.geometry import geometry

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        for mode in ("map", "map_remat"):
            rec = _port_rec(flexi, mode)
            state = rec.init_state(TorchDraws(torch.Generator().manual_seed(3)), pretrain_steps=100)
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                real_ckpt = geometry.checkpoint
                mp.setattr(geometry, "checkpoint", lambda *a, **k: calls.append(1) or real_ckpt(*a, **k))
                out[mode] = _tick_grads(rec.geo, rec, state, seed=11)
            assert len(calls) == (2 if mode == "map_remat" else 0), (mode, len(calls))
    finally:
        torch.use_deterministic_algorithms(prev)
    (loss_a, grads_a, gen_a, aux_a), (loss_b, grads_b, gen_b, _) = out["map"], out["map_remat"]
    assert float(loss_a[1]) > 0 and int(aux_a["n_faces"]) > 0
    for a, b in zip(loss_a, loss_b):
        assert torch.equal(a, b)
    assert len(grads_a) == len(grads_b) and any(g.abs().max() > 0 for g in grads_a)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)
    assert torch.equal(gen_a, gen_b)
