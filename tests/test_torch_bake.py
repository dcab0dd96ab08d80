"""The textured-asset pieces of the port against the JAX package, on the
CPU: the UV unwrap (the port's copy gives the original's atlas), ``render_uv``
(the bake), ``save_obj`` with UVs and a material (the same bytes),
``load_mtl`` / ``save_mtl`` and ``merge_materials`` on a two-material OBJ
(the same atlas level for level, texcoords and faces).

One deliberate difference is shown, not hidden: JAX's ``render_mesh``
interpolates the UVs of a Texture2D material with barycentrics recomputed
from ``v_clip`` gathered through the UV faces (``gshell_tpu/render/
render.py:297``), right only where UV and position faces coincide.  The
port takes the position faces' barycentrics (ROADMAP C), so a mesh whose
UV vertices are split renders as the same mesh with its positions split
alongside, which is what JAX renders too once the faces coincide.

Tolerances: the unwrap, the OBJ bytes, the MTL records, the atlas and the
remapped texcoords are equal; the bake's coverage is equal and its
material rtol 1e-5 / atol 2e-6 (the same hash-grid gathers at positions
interpolated in another order); the two-material renders at 48²: kd
buffers rtol 1e-5 / atol 1e-6."""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.ops.math import lookat, perspective
from gshell_tpu.ops.uv_unwrap import _grow_charts
from gshell_tpu.ops.uv_unwrap import unwrap as j_unwrap
from gshell_tpu.render import material as jmat
from gshell_tpu.render import mesh as jmesh
from gshell_tpu.render.light import update_pdf as j_update_pdf
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu.render.render import render_mesh as j_render_mesh
from gshell_tpu.render.render import render_uv as j_render_uv
from gshell_tpu_torch import convert
from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.ops.mesh_ops import compact_faces, orient_faces
from gshell_tpu_torch.ops.uv_unwrap import unwrap
from gshell_tpu_torch.render import material as tmat
from gshell_tpu_torch.render import mesh as tmesh
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.render.render import RenderFlags, render_mesh, render_uv
from gshell_tpu_torch.train_gshell import chart_count
from gshell_tpu_torch.utils.image import save_png
from gshell_tpu_torch.utils.rng import ReplayDraws
from gshell_tpu_torch.utils.synthetic_gt import skirt, sphere
from torch_parity import _draw, assert_close, n, t, view_key_for

torch.set_num_threads(1)
HASH = dict(n_levels=4, log2_table_size=10, base_resolution=4, desired_resolution=32)


def _skirt_surface():
    v, f = skirt(24, 6)
    return v.astype(np.float32), f.astype(np.int32)


def test_unwrap_copy_gives_the_original_atlas():
    for v, f in (_skirt_surface(), sphere(12, 8)):
        (uv_t, idx_t), (uv_j, idx_j) = unwrap(v, f), j_unwrap(v, f)
        np.testing.assert_array_equal(uv_t, uv_j)
        np.testing.assert_array_equal(idx_t, idx_j)
        assert uv_t.min() >= 0.0 and uv_t.max() <= 1.0


def test_chart_count_counts_uv_components():
    """Charts share UV vertices only inside themselves: the count of
    connected UV components is the unwrap's chart count."""
    v, f = sphere(12, 8)
    uvs, uv_idx = unwrap(v, f)
    assert chart_count(uv_idx, len(uvs)) == int(_grow_charts(v.astype(np.float64), f.astype(np.int64), 60.0).max()) + 1
    two = np.concatenate([uv_idx, uv_idx + len(uvs)])
    assert chart_count(two, 2 * len(uvs)) == 2 * chart_count(uv_idx, len(uvs))


def _edge_runs(faces):
    """Directed-edge counts: a shared edge wound consistently runs once each
    way; ``same`` counts shared edges run twice the same way."""
    runs = Counter((int(u), int(v)) for a, b, c in faces for u, v in ((a, b), (b, c), (c, a)))
    same = sum(1 for (u, v), k in runs.items() if k > 1)
    both = sum(1 for (u, v) in runs if u < v and (v, u) in runs)
    return same, both


@pytest.fixture(scope="module")
def cut_sphere():
    """The port's tets extractor on an ellipsoid SDF cut open at the top
    (grid 24): its faces as they are wound, as both packages' extractors
    wind them, about half facing each way."""
    geo = GShellGeometry(GeometryConfig(grid_res=24, scale=1.4), "cpu")
    x = geo.lattice_verts()
    with torch.no_grad():
        mesh = geo.extractor(x, torch.linalg.norm(x * torch.tensor([1.0, 1.2, 1.0]), dim=-1) - 0.5, 0.3 - x[:, 1])
        fc, fv, _ = compact_faces(mesh.faces, mesh.face_valid, geo.extractor.max_tets)
    f = n(fc[fv])
    f = f[~((f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 0] == f[:, 2]))]
    used, inv = np.unique(f.reshape(-1), return_inverse=True)
    return n(mesh.verts)[used], inv.reshape(-1, 3)


def test_orient_faces_winds_every_shared_edge_both_ways(cut_sphere):
    v, f = cut_sphere
    g = orient_faces(f)
    assert g.shape == f.shape and g.dtype == f.dtype
    np.testing.assert_array_equal(np.sort(g, axis=1), np.sort(f, axis=1))  # the same triangles, rewound
    same_before, _ = _edge_runs(f)
    same_after, both_after = _edge_runs(g)
    assert same_before > 0.2 * len(f) and same_after == 0 and both_after > len(f)
    c = v[g].mean(1)
    normal = np.cross(v[g[:, 1]] - v[g[:, 0]], v[g[:, 2]] - v[g[:, 0]])
    outward = (np.sum(normal * c, -1) > 0).mean()
    assert min(outward, 1.0 - outward) < 0.01, outward  # one surface, one side (the rim's faces tilt)


def test_oriented_faces_unwrap_into_fewer_larger_charts(cut_sphere):
    """JAX's bake unwraps the faces as wound: the signed normal cone admits
    no neighbour facing the other way, so the charts are a few faces each
    (ROADMAP C); wound consistently, the same surface unwraps into a few
    dozen charts and covers more of the atlas."""
    v, f = cut_sphere
    (uv_a, idx_a), (uv_b, idx_b) = j_unwrap(v, f), unwrap(v, orient_faces(f))
    charts_a, charts_b = chart_count(idx_a, len(uv_a)), chart_count(idx_b, len(uv_b))
    assert charts_a > 10 * charts_b and charts_b < 100, (charts_a, charts_b)


@pytest.fixture(scope="module")
def material():
    mat_j = jmat.MLPTexture3DConfig(channels=6, internal_dims=16, hidden=2, hash=JHashGridConfig(**HASH),
                                    min_max=jmat.default_kd_ks_min_max())
    mat_t = tmat.MLPTexture3DConfig(channels=6, internal_dims=16, hidden=2, hash=HashGridConfig(**HASH),
                                    min_max=jmat.default_kd_ks_min_max())
    params_j = jmat.init_mlp_texture(jax.random.PRNGKey(7), mat_j)
    # tables at a scale that makes kd vary across the surface
    tables = np.random.default_rng(0).uniform(-1, 1, size=np.asarray(params_j.tables.tables).shape)
    params_j = params_j._replace(tables=params_j.tables._replace(tables=jnp.asarray(tables, jnp.float32)))
    return mat_j, mat_t, params_j, convert.params_mat_from_jax(params_j, "cpu")


def test_render_uv_matches_jax(material):
    mat_j, mat_t, params_j, params_t = material
    v, f = _skirt_surface()
    uvs, uv_idx = unwrap(v, f)
    mask_j, kd_j, ks_j = j_render_uv(jnp.asarray(uvs), jnp.asarray(uv_idx), jnp.asarray(v), jnp.asarray(f),
                                     (64, 64), params_j, mat_j)
    mask_t, kd_t, ks_t = render_uv(t(uvs), t(uv_idx).long(), t(v), t(f).long(), (64, 64), params_t, mat_t)
    np.testing.assert_array_equal(n(mask_t), np.asarray(mask_j))
    assert 0.2 < float(mask_t.mean()) < 1.0
    assert_close(kd_t, kd_j, rtol=1e-5, atol=2e-6, what="kd atlas")
    assert_close(ks_t, ks_j, rtol=1e-5, atol=2e-6, what="ks atlas")
    assert n(kd_t)[n(mask_t)[..., 0] > 0].std(axis=0).min() > 0.01, "kd varies over the charts"
    # background texels hold the material at the origin, as JAX's
    origin = n(tmat.sample_mlp_texture(params_t, mat_t, torch.zeros(1, 3)))[0]
    assert_close(n(kd_t)[n(mask_t)[..., 0] == 0], np.broadcast_to(origin[:3], (int((n(mask_t) == 0).sum()), 3)),
                 rtol=1e-6, what="background texels")


@pytest.mark.parametrize("uv_case", ["uvs", "mtl only", "plain"])
def test_save_obj_writes_the_jax_bytes(tmp_path, uv_case):
    v, f = _skirt_surface()
    rng = np.random.default_rng(1)
    v = (v + rng.normal(scale=1e-3, size=v.shape)).astype(np.float32)
    f = f.copy()
    f[::9, 1] = f[::9, 0]  # degenerate faces, dropped
    valid = rng.uniform(size=len(f)) > 0.2
    kw_j, kw_t = {}, {}
    if uv_case == "uvs":
        uvs, uv_idx = unwrap(v, f)
        kw_j = dict(uvs=uvs, uv_idx=uv_idx, mtl_name="baked")
        kw_t = dict(uvs=t(uvs), uv_idx=t(uv_idx), mtl_name="baked")
    elif uv_case == "mtl only":
        kw_j = kw_t = dict(mtl_name="baked")
    jmesh.save_obj(str(tmp_path / "j.obj"), v, f, valid, **kw_j)
    n_faces = tmesh.save_obj(str(tmp_path / "t.obj"), t(v), t(f).long(), t(valid), **kw_t)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    assert n_faces == sum(1 for line in open(tmp_path / "t.obj") if line.startswith("f "))


def _two_material_obj(tmp_path):
    (tmp_path / "two.obj").write_text("""mtllib two.mtl
v -0.4 -0.4 0
v 0.4 -0.4 0
v 0.4 0.4 0
v -0.4 0.4 0
vt 0.25 0.25
vt 0.75 0.25
vt 0.75 0.75
vt 0.25 0.75
usemtl matA
f 1/1 2/2 3/3
usemtl matB
f 1/1 3/3 4/4
""")
    rng = np.random.default_rng(2)
    save_png(str(tmp_path / "a_kd.png"), (rng.uniform(size=(8, 8, 3)) * 255).astype(np.uint8))
    save_png(str(tmp_path / "b_ks.png"), (rng.uniform(size=(4, 16, 3)) * 255).astype(np.uint8))
    (tmp_path / "two.mtl").write_text("newmtl matA\nbsdf pbr\nmap_Kd a_kd.png\nKs 0.0 0.6 0.0\n\n"
                                      "newmtl matB\nbsdf pbr\nKd 0.0 0.0 1.0\nmap_Ks b_ks.png\n")
    return str(tmp_path / "two.obj")


def test_mtl_round_trip_matches_jax(tmp_path):
    path = _two_material_obj(tmp_path)
    mtl = str(tmp_path / "two.mtl")
    assert tmat.load_mtl(mtl) == jmat.load_mtl(mtl)
    assert [m["name"] for m in tmat.load_mtl(mtl)] == ["matA", "matB"]
    tmat.save_mtl(str(tmp_path / "t.mtl"), "m", (0.1, 0.2, 0.3), (0.0, 0.4, 0.5))
    jmat.save_mtl(str(tmp_path / "j.mtl"), "m", (0.1, 0.2, 0.3), (0.0, 0.4, 0.5))
    assert (tmp_path / "t.mtl").read_bytes() == (tmp_path / "j.mtl").read_bytes()
    mesh_t, attrs_t = tmesh.load_obj(path, with_attrs=True)
    mesh_j, attrs_j = jmesh.load_obj(path, with_attrs=True)
    assert_close(mesh_t.v_tex, mesh_j.v_tex, rtol=0, what="texcoords")
    for k in ("t_tex_idx", "m_face_idx"):
        np.testing.assert_array_equal(attrs_t[k], attrs_j[k])
    assert attrs_t["mat_names"] == attrs_j["mat_names"] == ["matA", "matB"]


def test_merge_materials_matches_jax(tmp_path):
    """The two-material quad of ``tests/test_render_buffers.py`` with a kd
    PNG on one material and a ks PNG on the other: the atlas of each
    channel (every mip level), the texcoords and the faces are JAX's."""
    path = _two_material_obj(tmp_path)
    mats = tmat.load_mtl(str(tmp_path / "two.mtl"))
    mesh, attrs = tmesh.load_obj(path, with_attrs=True)
    texcoords = n(mesh.v_tex)
    uber_t, uv_t, tf_t = tmat.merge_materials(mats, texcoords, attrs["t_tex_idx"], attrs["m_face_idx"])
    uber_j, uv_j, tf_j = jmat.merge_materials(jmat.load_mtl(str(tmp_path / "two.mtl")), texcoords,
                                             attrs["t_tex_idx"], attrs["m_face_idx"])
    np.testing.assert_array_equal(uv_t, uv_j)
    np.testing.assert_array_equal(tf_t, tf_j)
    assert uv_t.shape == (6, 2) and (uber_t["name"], uber_t["bsdf"]) == (uber_j["name"], uber_j["bsdf"])
    assert sorted(k for k in uber_t if k in ("kd", "ks", "normal")) == ["kd", "ks"]
    for c in ("kd", "ks"):
        assert uber_t[c].base.shape == (8, 32, 3)  # tiles of max(8x8, 4x16), two along u, to powers of 2
        assert len(uber_t[c].mips) == len(uber_j[c].mips)
        for a, b in zip(uber_t[c].mips, uber_j[c].mips):
            assert_close(a, b, rtol=1e-6, atol=1e-7, what=f"{c} atlas")


def _quad_view():
    mvp = np.asarray(perspective(np.deg2rad(45.0)) @ lookat(jnp.array([0.0, 0.0, 2.0]), jnp.zeros(3),
                                                            jnp.array([0.0, 1.0, 0.0])))
    return mvp, np.float32([0.0, 0.0, 2.0])


def test_split_uv_faces_render_as_split_positions(tmp_path):
    """The merged quad's UV faces differ from its position faces (6 UV
    vertices, 4 positions).  The port renders it as the quad with its
    positions split to match the UVs (``t_pos_idx == t_tex_idx``), and so
    does JAX given the split positions; JAX given the shared positions
    gathers clip vertices through the UV faces and renders other UVs."""
    path = _two_material_obj(tmp_path)
    mats = tmat.load_mtl(str(tmp_path / "two.mtl"))
    mesh, attrs = tmesh.load_obj(path, with_attrs=True)
    uber, new_uv, new_tf = tmat.merge_materials(mats, n(mesh.v_tex), attrs["t_tex_idx"], attrs["m_face_idx"])
    uber_j, _, _ = jmat.merge_materials(jmat.load_mtl(str(tmp_path / "two.mtl")), n(mesh.v_tex),
                                       attrs["t_tex_idx"], attrs["m_face_idx"])
    faces = n(mesh.t_pos_idx).astype(np.int32)
    v = n(mesh.v_pos)
    split_v = np.zeros((len(new_uv), 3), np.float32)
    split_v[new_tf.reshape(-1)] = v[faces.reshape(-1)]
    nrm = np.tile(np.float32([[0.0, 0.0, 1.0]]), (len(new_uv), 1))
    mvp, campos = _quad_view()
    res = 48
    key = jax.random.PRNGKey(4)
    light_base = np.ones((16, 32, 3), np.float32)

    def port(verts, t_pos):
        draws = ReplayDraws(lambda kind, name, shape, lo, hi: _draw(kind, view_key_for(key, name), shape, lo, hi))
        return render_mesh(draws, t(verts), t(t_pos).long(), t(nrm[:len(verts)]), None,
                           tmat.texture_material(uber), None, t(mvp), t(campos), update_pdf(t(light_base)),
                           RenderFlags(resolution=(res, res), n_samples=2, bsdf="kd", use_denoiser=False),
                           v_tex=t(new_uv), t_tex_idx=t(new_tf).long())

    def jax_render(verts, t_pos):
        return j_render_mesh(key, jnp.asarray(verts), jnp.asarray(t_pos), jnp.asarray(nrm[:len(verts)]), None,
                             uber_j, None, jnp.asarray(mvp), jnp.asarray(campos), j_update_pdf(jnp.asarray(light_base)),
                             JRenderFlags(resolution=(res, res), n_samples=2, bsdf="kd", use_denoiser=False,
                                          raster_backend="xla", max_per_tile=4096),
                             v_tex=jnp.asarray(new_uv), t_tex_idx=jnp.asarray(new_tf))

    with torch.no_grad():
        shared, split = port(v, faces), port(split_v, new_tf)
    j_split, j_shared = jax_render(split_v, new_tf), jax_render(v, faces)
    mask = n(split["mask"])[..., 0] > 0
    assert mask.sum() > 500
    assert_close(shared["kd"], split["kd"], rtol=1e-5, atol=1e-6, what="port: shared vs split positions")
    assert_close(split["kd"], j_split["kd"], rtol=1e-5, atol=1e-6, what="port vs JAX, split positions")
    off = np.abs(np.asarray(j_shared["kd"]) - np.asarray(j_split["kd"]))[mask].max(-1)
    assert (off > 0.05).mean() > 0.05, "JAX's UVs through the UV faces differ on shared positions"
