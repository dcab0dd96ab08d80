"""Textures, image resizing, cubemap prefilters, the direct-light BSDFs and
the light's image of the port against the JAX package, on the CPU, from
the same seeded numpy inputs.

Tolerances: texture sampling and its gradients to every mip level rtol
1e-5 / atol 1e-6, to the UVs rtol 1e-5 / atol 1e-6 of the largest (the
same gathers and products); resizes and
pooling rtol 1e-5 / atol 1e-6 (the same weights, summed in another order);
the cubemap prefilters rtol 1e-4 / atol 1e-6 (N² dot products summed in
another order); the BSDFs rtol 1e-5 / atol 1e-6, their gradients rtol 1e-4
/ atol 1e-6 (a pow and a sqrt whose CPU implementations differ by an ulp);
tangents rtol 1e-5 / atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.ops import bsdf as jbsdf
from gshell_tpu.ops import cubemap as jcube
from gshell_tpu.ops import math as jm
from gshell_tpu.ops import mesh_ops as jmo
from gshell_tpu.render import light as jlt
from gshell_tpu.render import texture as jtex
from gshell_tpu_torch import convert
from gshell_tpu_torch.ops import bsdf as tbsdf
from gshell_tpu_torch.ops import cubemap as tcube
from gshell_tpu_torch.ops import math as tm
from gshell_tpu_torch.ops import mesh_ops as tmo
from gshell_tpu_torch.render import light as tlt
from gshell_tpu_torch.render import texture as ttex
from gshell_tpu_torch.utils.synthetic_gt import sphere
from torch_parity import assert_close, n, t

torch.set_num_threads(1)


def _uv_and_derivs(p, seed, scale):
    """UVs in [-0.05, 1.05]² (the clamped border included) and screen
    derivatives whose footprints span every level of a 32² chain."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.05, 1.05, size=(p, 2)).astype(np.float32)
    d = (rng.normal(size=(p, 4)) * np.exp(rng.uniform(-6, 0, size=(p, 1))) * scale).astype(np.float32)
    return uv, d


@pytest.mark.parametrize("lod", [False, True], ids=["base level", "lod blend"])
def test_sample_and_its_gradients_match_jax(lod):
    rng = np.random.default_rng(0)
    base = rng.uniform(size=(32, 32, 4)).astype(np.float32)
    uv, d = _uv_and_derivs(500, 1, 1.0)
    g = rng.normal(size=(500, 4)).astype(np.float32)
    tex_j = jtex.build_mips(jnp.asarray(base))
    assert len(tex_j.mips) == 6

    def fj(mips, u):
        out = jtex.sample(jtex.Texture2D(mips=mips), u, jnp.asarray(d) if lod else None)
        return jnp.sum(out * g), out

    (_, out_j), (g_mips_j, g_uv_j) = jax.value_and_grad(fj, argnums=(0, 1), has_aux=True)(
        tex_j.mips, jnp.asarray(uv))
    tex_t = convert.texture_from_jax(tex_j, "cpu")
    mips = tuple(m.requires_grad_(True) for m in tex_t.mips)
    uv_t = t(uv, True)
    out_t = ttex.sample(ttex.Texture2D(mips=mips), uv_t, t(d) if lod else None)
    torch.sum(out_t * t(g)).backward()
    assert_close(out_t, out_j, rtol=1e-5, atol=1e-6, what="sample")
    for k, (mt, gj) in enumerate(zip(mips, g_mips_j)):
        assert_close(torch.zeros_like(mt) if mt.grad is None else mt.grad, gj, rtol=1e-5, atol=1e-6,
                     what=f"d/dmip{k}")
        if lod or k == 0:
            assert np.abs(np.asarray(gj)).max() > 0, f"level {k} got no gradient"
    # d/duv is a difference of texel products scaled by the texture's size
    assert_close(uv_t.grad, g_uv_j, rtol=1e-5, atol=1e-6 * np.abs(np.asarray(g_uv_j)).max(), what="d/duv")


def test_texture_helpers_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(-0.2, 1.2, size=(16, 8, 3)).astype(np.float32)
    a, b = jtex.create_trainable(img), ttex.create_trainable(t(img))
    assert len(a.mips) == len(b.mips) == 4
    for ma, mb in zip(a.mips, b.mips):
        assert_close(mb, ma, rtol=1e-6, atol=1e-7, what="mips")
    flat_j = jtex.create_trainable(np.float32([0.2, 0.5, 0.7]), res=(4, 4), auto_mipmaps=False)
    flat_t = ttex.create_trainable(t(np.float32([0.2, 0.5, 0.7])), res=(4, 4), auto_mipmaps=False)
    assert len(flat_t.mips) == 1
    assert_close(flat_t.base, flat_j.base, rtol=0, what="flat")
    for fj, ft in ((jtex.clamp, ttex.clamp), (jtex.normalize, ttex.normalize),
                   (jtex.srgb_to_linear, ttex.srgb_to_linear)):
        for ma, mb in zip(fj(a).mips, ft(b).mips):
            assert_close(mb, ma, rtol=1e-5, atol=1e-6, what=fj.__name__)


@pytest.mark.parametrize("size, method", [
    ((8, 12), "linear"),  # shrinks: antialiased
    ((5, 7), "bilinear"),  # shrinks by a non-integer factor
    ((40, 64), "linear"),  # grows: half-pixel, edges clamped
    ((24, 9), "bilinear"),  # grows one axis, shrinks the other
    ((40, 7), "nearest"),
])
def test_scale_img_nhwc_matches_jax(size, method):
    x = np.random.default_rng(3).uniform(size=(2, 16, 24, 3)).astype(np.float32)
    assert_close(tm.scale_img_nhwc(t(x), size, method=method), jm.scale_img_nhwc(jnp.asarray(x), size, method=method),
                 rtol=1e-5, atol=1e-6, what=f"{method} to {size}")


def test_pooling_grid_srgb_and_cubemap_lookup_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(1, 16, 8, 3)).astype(np.float32)
    assert_close(tm.avg_pool_nhwc(t(x), 4), jm.avg_pool_nhwc(jnp.asarray(x), 4), rtol=1e-6, atol=1e-7, what="pool")
    assert_close(tm.pixel_grid(12, 5), jm.pixel_grid(12, 5), rtol=0, what="pixel_grid")
    c = rng.uniform(size=(6, 6, 4)).astype(np.float32)
    assert_close(tm.srgb_to_rgb(t(c)), jm.srgb_to_rgb(jnp.asarray(c)), rtol=1e-5, atol=1e-7, what="srgb_to_rgb")
    latlong = rng.uniform(size=(16, 32, 3)).astype(np.float32)
    assert_close(tm.latlong_to_cubemap(t(latlong), 8), jm.latlong_to_cubemap(jnp.asarray(latlong), 8), rtol=0,
                 what="latlong_to_cubemap")


@pytest.mark.parametrize("res", [(8, 16), (64, 128)], ids=["shrinks", "grows"])
def test_generate_image_matches_jax(res):
    base = np.random.default_rng(5).uniform(0.25, 0.75, size=(32, 64, 3)).astype(np.float32)
    img_t = tlt.generate_image(tlt.update_pdf(t(base)), res)
    assert tuple(img_t.shape) == res + (3,)
    assert_close(img_t, jlt.generate_image(jlt.update_pdf(jnp.asarray(base)), res), rtol=1e-5, atol=1e-6,
                 what="generate_image")


def test_cubemap_prefilters_match_jax():
    res = 8
    cube = np.random.default_rng(6).uniform(0.1, 2.0, size=(6, res, res, 3)).astype(np.float32)
    assert_close(tcube.cube_dirs(res), jcube.cube_dirs(res), rtol=1e-6, atol=1e-7, what="cube_dirs")
    assert_close(tcube.texel_solid_angles(res), jcube.texel_solid_angles(res), rtol=1e-6, what="solid angles")
    assert abs(float(tcube.texel_solid_angles(res).sum()) - 4 * np.pi) < 0.05
    g = np.random.default_rng(7).normal(size=cube.shape).astype(np.float32)
    out_j, vjp = jax.vjp(jcube.diffuse_cubemap, jnp.asarray(cube))
    ct = t(cube, True)
    out_t = tcube.diffuse_cubemap(ct)
    torch.sum(out_t * t(g)).backward()
    assert_close(out_t, out_j, rtol=1e-4, atol=1e-6, what="diffuse")
    assert_close(ct.grad, vjp(jnp.asarray(g))[0], rtol=1e-4, atol=1e-6, what="d diffuse / d cubemap")
    for r in (0.1, 0.5):
        assert_close(tcube.specular_cubemap(t(cube), r), jcube.specular_cubemap(jnp.asarray(cube), r), rtol=1e-4,
                     atol=1e-6, what=f"specular {r}")
    chain_t, chain_j = tcube.specular_mip_chain(t(cube)), jcube.specular_mip_chain(jnp.asarray(cube))
    assert len(chain_t) == len(chain_j) == 2
    for k, (a, b) in enumerate(zip(chain_t, chain_j)):
        assert_close(a, b, rtol=1e-4, atol=1e-6, what=f"mip chain level {k}")


def _bsdf_inputs(p=400, seed=8):
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    pos = f(rng.uniform(-0.5, 0.5, size=(p, 3)))
    nrm = f(unit(rng.normal(size=(p, 3))))
    view = f(pos + 3.0 * unit(rng.normal(size=(p, 3)) + nrm))
    light_pos = f(pos + 2.0 * unit(rng.normal(size=(p, 3)) + nrm))
    kd = f(rng.uniform(size=(p, 3)))
    arm = f(np.stack([rng.uniform(0, 0.5, p), rng.uniform(0.2, 1.0, p), rng.uniform(0, 1, p)], -1))
    return kd, arm, pos, nrm, view, light_pos


@pytest.mark.parametrize("which", ["frostbite_diffuse", "pbr_bsdf lambert", "pbr_bsdf frostbite",
                                   "pbr_bsdf_separate"])
def test_direct_light_bsdfs_match_jax(which):
    kd, arm, pos, nrm, view, light_pos = _bsdf_inputs()
    wi = (light_pos - pos) / np.linalg.norm(light_pos - pos, axis=-1, keepdims=True)
    wo = (view - pos) / np.linalg.norm(view - pos, axis=-1, keepdims=True)

    def call(mod, kd_, arm_, nrm_, lib):
        if which == "frostbite_diffuse":
            return (mod.frostbite_diffuse(nrm_, lib(wi), lib(wo), arm_[..., 1:2]),)
        if which.startswith("pbr_bsdf "):
            return (mod.pbr_bsdf(kd_, arm_, lib(pos), nrm_, lib(view), lib(light_pos),
                                 bsdf=0 if which.endswith("lambert") else 1),)
        return mod.pbr_bsdf_separate(kd_, arm_, lib(pos), nrm_, lib(view), lib(wi))

    g = np.random.default_rng(9).normal(size=(kd.shape[0], 3)).astype(np.float32)

    def fj(kd_, arm_, nrm_):
        outs = call(jbsdf, kd_, arm_, nrm_, jnp.asarray)
        return sum(jnp.sum(o * g[:, :o.shape[-1]]) for o in outs), outs

    (_, outs_j), grads_j = jax.value_and_grad(fj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(kd), jnp.asarray(arm), jnp.asarray(nrm))
    leaves = [t(a, True) for a in (kd, arm, nrm)]
    outs_t = call(tbsdf, *leaves, t)
    sum(torch.sum(o * t(g)[:, :o.shape[-1]]) for o in outs_t).backward()
    for k, (a, b) in enumerate(zip(outs_t, outs_j)):
        assert_close(a, b, rtol=1e-5, atol=1e-6, what=f"{which} output {k}")
        assert np.abs(n(a)).max() > 0
    for name, leaf, gj in zip(("kd", "arm", "nrm"), leaves, grads_j):
        gt = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        assert_close(gt, gj, rtol=1e-4, atol=1e-6 * max(np.abs(np.asarray(gj)).max(), 1.0), what=f"d/d{name}")


def test_compute_tangents_match_jax():
    v, f = sphere(12, 8)
    uv = np.stack([0.5 + np.arctan2(v[:, 0], v[:, 2]) / (2 * np.pi), np.arccos(np.clip(v[:, 1], -1, 1)) / np.pi],
                  -1).astype(np.float32)
    nrm = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.ones(len(f), bool)
    mask[::7] = False
    for fm in (None, mask):
        a = tmo.compute_tangents(t(v), t(uv), t(nrm), t(f).long(), t(f).long(), None if fm is None else t(fm))
        b = jmo.compute_tangents(jnp.asarray(v), jnp.asarray(uv), jnp.asarray(nrm), jnp.asarray(f), jnp.asarray(f),
                                 None if fm is None else jnp.asarray(fm))
        assert_close(a, b, rtol=1e-5, atol=1e-6, what="tangents")
