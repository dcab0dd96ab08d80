"""Port geometry (G-Shell extraction, mesh ops, leaf math) vs the JAX package.

The extraction is compared slot for slot: faces, validity masks and counts
exactly (both compact with stable sorts in the same order), vertex
positions and mSDF values to rtol 1e-5 (the same interpolation, one rounding
apart), and the gradients of a weighted sum of the outputs w.r.t. the
lattice positions and the mSDF to rtol 1e-4.  Both sides use the lazy path
with the same analytic SDF (a perturbed sphere) evaluated at the crossing
edge ends.  Mesh ops and leaf math to rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.geometry.gshell_tets import GShellTets as JGShellTets
from gshell_tpu.geometry.tet_grid import build_tet_grid
from gshell_tpu.ops import math as jm
from gshell_tpu.ops import mesh_ops as jmo
from gshell_tpu_torch.geometry.gshell_tets import GShellTets
from gshell_tpu_torch.ops import math as tm
from gshell_tpu_torch.ops import mesh_ops as tmo
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_parity import assert_close, n, t

torch.set_num_threads(1)
RES = 12


@pytest.fixture(scope="module")
def grid():
    return build_tet_grid(RES)


def _sdf_np_params():
    rng = np.random.default_rng(0)
    return rng.normal(size=(3,)).astype(np.float32) * 0.05


def _sdf_j(p, c):
    return 0.38 - jnp.linalg.norm(p - c, axis=-1) + 0.03 * jnp.sin(5.0 * p[..., 0])


def _sdf_t(p, c):
    return 0.38 - torch.linalg.norm(p - c, dim=-1) + 0.03 * torch.sin(5.0 * p[..., 0])


@pytest.mark.parametrize("cut", [False, True])
def test_gshell_tets_matches_jax(grid, cut):
    c = _sdf_np_params()
    rng = np.random.default_rng(1)
    pos = (np.asarray(grid.verts) + rng.uniform(-0.01, 0.01, size=np.shape(grid.verts))).astype(np.float32)
    msdf = (pos[:, 2] + 0.3 * pos[:, 0] + 0.05) if cut else np.ones(len(pos), np.float32)
    msdf = msdf.astype(np.float32)
    sdf = np.asarray(_sdf_j(jnp.asarray(pos), jnp.asarray(c)))
    wv = rng.normal(size=(1,)).astype(np.float32)
    ext_j = JGShellTets(grid)
    ext_t = GShellTets(grid, "cpu")

    def out_j(p, ms):
        return ext_j(p, jnp.asarray(sdf), ms, watertight_template=True, compute_aug_normals=False,
                     compute_tangents=False, sdf_fn=lambda q: _sdf_j(q, jnp.asarray(c)))

    def loss_j(p, ms):
        m = out_j(p, ms)
        w = jnp.sin(jnp.arange(m.verts.size, dtype=jnp.float32)).reshape(m.verts.shape)
        return jnp.sum(m.verts * w) + wv[0] * jnp.sum(m.edge_sdf ** 2)

    mj = out_j(jnp.asarray(pos), jnp.asarray(msdf))
    g_pos_j, g_msdf_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(msdf))

    p_t, ms_t = t(pos, True), t(msdf, True)
    mt = ext_t(p_t, t(sdf), ms_t, sdf_fn=lambda q: _sdf_t(q, t(c)))
    np.testing.assert_array_equal(n(mt.faces), np.asarray(mj.faces))
    np.testing.assert_array_equal(n(mt.face_valid), np.asarray(mj.face_valid))
    assert int(mt.n_valid_tets) == int(mj.n_valid_tets) > 0
    assert int(mt.n_crossing_edges) == int(mj.n_crossing_edges)
    assert int(mt.face_valid.sum()) > 0
    assert_close(mt.verts, mj.verts, rtol=1e-5, atol=1e-6, what="verts")
    assert_close(mt.msdf, mj.msdf, rtol=1e-5, atol=1e-6, what="msdf")
    assert_close(mt.msdf_boundary, mj.msdf_boundary, rtol=1e-5, atol=1e-6, what="msdf_boundary")
    assert_close(mt.edge_sdf, mj.edge_sdf, rtol=1e-5, atol=1e-6, what="edge_sdf")
    if cut:
        assert np.abs(np.asarray(mj.msdf_boundary)).max() > 0
    w = torch.sin(torch.arange(mt.verts.numel(), dtype=torch.float32)).reshape(mt.verts.shape)
    (torch.sum(mt.verts * w) + float(wv[0]) * torch.sum(mt.edge_sdf ** 2)).backward()
    assert_close(p_t.grad, g_pos_j, rtol=1e-4, atol=1e-5, what="d/dpos")
    assert_close(ms_t.grad, g_msdf_j, rtol=1e-4, atol=1e-5, what="d/dmsdf")
    if cut:
        assert np.abs(np.asarray(g_msdf_j)).max() > 0


def _mesh(seed, nv=60, nf=100):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(nv, 3)).astype(np.float32)
    f = rng.integers(0, nv, size=(nf, 3)).astype(np.int64)
    mask = rng.uniform(size=(nf,)) < 0.7
    return v, f, mask


def test_mesh_ops_match_jax():
    v, f, mask = _mesh(2)
    vj, fj, mj = jnp.asarray(v), jnp.asarray(f.astype(np.int32)), jnp.asarray(mask)
    vt, ft, mt_ = t(v), torch.as_tensor(f), torch.as_tensor(mask)
    assert_close(tmo.face_normals(vt, ft), jmo.face_normals(vj, fj), rtol=1e-5, atol=1e-6, what="fn")
    assert_close(tmo.auto_normals(vt, ft, mt_), jmo.auto_normals(vj, fj, mj), rtol=1e-5, atol=1e-6,
                 what="auto_normals")
    np.testing.assert_array_equal(n(tmo.compute_edges(ft)), np.asarray(jmo.compute_edges(fj)))
    assert_close(tmo.face_areas(vt, ft), jmo.face_areas(vj, fj), rtol=1e-5, atol=1e-7, what="areas")
    fc_t, valid_t, cnt_t = tmo.compact_faces(ft, mt_, 80)
    fc_j, valid_j, cnt_j = jmo.compact_faces(fj, mj, 80)
    np.testing.assert_array_equal(n(fc_t), np.asarray(fc_j))
    np.testing.assert_array_equal(n(valid_t), np.asarray(valid_j))
    assert int(cnt_t) == int(cnt_j)
    key = jax.random.PRNGKey(3)
    k_face, k_uv = jax.random.split(key)
    keys = {"face": k_face, "uv": k_uv}
    draws = ReplayDraws(lambda kind, name, shape, lo, hi: np.asarray(
        jax.random.uniform(keys[name], shape)))
    s_t = tmo.sample_surface(draws, vt, ft, 300, face_mask=mt_)
    s_j = jmo.sample_surface(key, vj, fj, 300, face_mask=mj)
    assert_close(s_t, s_j, rtol=1e-5, atol=1e-6, what="sample_surface")


def test_leaf_math_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    nrm = x / np.linalg.norm(x, axis=-1, keepdims=True)
    y = rng.normal(size=(50, 3)).astype(np.float32)
    assert_close(tm.reflect(t(y), t(nrm)), jm.reflect(jnp.asarray(y), jnp.asarray(nrm)), rtol=1e-5, atol=1e-6,
                 what="reflect")
    assert_close(tm.luminance(t(np.abs(y))), jm.luminance(jnp.asarray(np.abs(y))), rtol=1e-6, what="luminance")
    for a, b in zip(tm.build_orthonormal_basis(t(nrm)), jm.build_orthonormal_basis(jnp.asarray(nrm))):
        assert_close(a, b, rtol=1e-5, atol=1e-6, what="onb")
    uv = tm.dir_to_latlong_uv(t(nrm))
    assert_close(uv, jm.dir_to_latlong_uv(jnp.asarray(nrm)), rtol=1e-5, atol=1e-6, what="latlong uv")
    assert_close(tm.latlong_uv_to_dir(uv), jm.latlong_uv_to_dir(jnp.asarray(n(uv))), rtol=1e-5, atol=1e-6,
                 what="uv to dir")
    proj_t = tm.perspective(0.7, 1.3, 0.2, 50.0)
    proj_j = jm.perspective(0.7, 1.3, 0.2, 50.0)
    assert_close(proj_t, proj_j, rtol=1e-6, what="perspective")
    view_t = tm.lookat([0.3, 1.0, 2.5], [0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    view_j = jm.lookat(jnp.array([0.3, 1.0, 2.5]), jnp.array([0.0, 0.1, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    assert_close(view_t, view_j, rtol=1e-5, atol=1e-6, what="lookat")
    assert_close(tm.xfm_points(t(x), proj_t @ view_t), jm.xfm_points(jnp.asarray(x), proj_j @ view_j),
                 rtol=1e-5, atol=1e-5, what="xfm_points")
    xt = t(x, True)
    tm.scale_grad(xt, 128.0).sum().backward()
    np.testing.assert_array_equal(n(xt.grad), np.asarray(jax.grad(lambda a: jm.scale_grad(a, 128.0).sum())(
        jnp.asarray(x))))
