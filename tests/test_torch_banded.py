"""The (view × band) banded render of the port (``parallel/spatial.py``) and
the banded ticks of both geometries against the JAX package's, on the CPU,
at the sizes of JAX's ``_banded_setup`` (``tests/test_parallel.py``: 64²,
tet grid 16, two views, n_samples 2; ``tests/torch_banded.py``).

* The render, 2 views × 2 bands in local mode (one process renders every
  cell), against JAX's ``render_batch_banded`` on a (2, 2) mesh of the CPU
  devices, both rendering JAX's extracted mesh with the same per-band
  draws: every image buffer by its share of pixels off by more than 1e-4
  (``EXACT_BUFFERS`` 0.1 %, the Monte-Carlo ones 3 % and a mean error of
  3e-4: a few samples flip on float32 round-off and the denoiser spreads
  them), ``visible_vert_mask`` to JAX's 0.5 % (a silhouette pixel moves a
  vertex or two; reading 0.03 %) and the counters exactly.
* The banded render against the port's unbanded one, with the ``kd`` BSDF:
  at least 99 % of the pixels of ``shaded``, ``mask``, ``msdf_image`` and
  ``invdepth`` equal outside rows 0 and H − 1 (JAX's own rule,
  ``tests/test_parallel.py:266-284``).
* Both ticks in local mode against JAX's ``tick(spatial_mesh=…)``: every
  loss term to ``LOSS_RTOL`` and each gradient group by cosine and relative
  norm difference (``LIMITS``, about 1.5x the readings, taken on an earlier
  test host, its CPU model not recorded; the groups of ``ENVELOPED``
  at the looser of that and 3x the port's round-off envelope, never above
  10x it).
* Both train steps on two gloo ranks (``tests/torch_dist.py``; the tets
  extraction sharded over them) against one process holding all four
  cells: the losses to rtol 1e-6 (they read equal), the gradients the
  optimizers took to 5e-6 relative norm per parameter (readings to 2.1e-6:
  the ranks' gradients are averaged, the process sums them in another
  order), and the parameters after the step to 1e-6 of the larger of the
  parameter and the step size lr (a parameter the step takes near 0 keeps
  the rounding of its start) beyond what that rounding of each gradient
  moves Adam's first update lr·g/(|g| + ε) by (twice lr·ε·|δg|/(|g| + ε)²;
  it matters only where |g| is near ε); both ranks' values bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gshell_tpu.geometry.flexi_geometry import FlexiGeometryConfig as JFlexiGeometryConfig
from gshell_tpu.geometry.flexi_geometry import GShellFlexiGeometry as JGShellFlexiGeometry
from gshell_tpu.geometry.geometry import GeometryConfig as JGeometryConfig
from gshell_tpu.geometry.geometry import GShellGeometry as JGShellGeometry
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.ops.image_loss import create_loss as j_create_loss
from gshell_tpu.ops.mesh_ops import auto_normals as j_auto_normals
from gshell_tpu.ops.mesh_ops import compact_faces as j_compact_faces
from gshell_tpu.parallel.spatial import render_batch_banded as j_render_batch_banded
from gshell_tpu.render.light import update_pdf as j_update_pdf
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu.render.render import render_mesh as j_render_mesh
from gshell_tpu_torch import convert
from gshell_tpu_torch.parallel.spatial import CellGrid, render_batch_banded
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.render.render import render_mesh
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_banded import BATCH, FLAGS, GEO, HASH, MAT, RES, STEP, banded_reconstructor, initial_state, \
    reconstructor, step_record, target
from torch_dist import run_ranks
from torch_parity import (_draw, assert_cosine_and_norm, band_key_for, flexi_train_source, jittered_runs, n, t,
                          train_source, view_key_for)

torch.set_num_threads(1)
NV, NB = 2, 2
ADAM_EPS = 1e-8
# The render against JAX's: buffers that do not depend on the Monte-Carlo
# walk, at least 99.9 % of their pixels within 1e-4 (readings: kd, ks, their
# smoothness taps and mask exact to 1.4e-5; geometric normal, invdepth and
# mSDF image 0.037 % off, a silhouette pixel or three); the others (the
# light, its denoised sum, the shaded colour and the perturbed normals) at
# least 97 % (readings 0.6-2.3 %) with a mean |error| of at most 3e-4
# (readings to 1.9e-4).
EXACT_BUFFERS = ("kd", "ks", "kd_grad", "ks_grad", "mask", "geometric_normal", "invdepth", "msdf_image")
# The groups that on an "AMD EPYC" host (``lscpu``) read above their limits:
# held at the looser of the limit and 3× the port's round-off envelope,
# never above 10× the limit (``torch_parity.cosine_and_norm_limits``).  One
# ulp of round-off puts 3.2 % of the tets tick's image elements on other
# branches (shadows, the denoiser's spread; ``torch_parity.branch_mask``),
# too many to leave out of the loss.  Readings there: tets deform .99622
# 5.11e-3, tables .99971 5.00e-3; flexicubes deform .9999882 2.11e-4, sdf
# .999951 8.01e-4, light .99867 1.22e-4.
ENVELOPED = {"tets": ("deform", "tables"), "flexicubes": ("deform", "sdf", "light")}
# Loss terms, relative error (readings: tets 7.7e-5, FlexiCubes 1.3e-5), and
# per gradient group (cosine >=, relative norm difference <=), about 1.5x off
# the readings:
#   tets        deform .99328 1.43e-3 | msdf .99905 1.47e-3 | sdf .98915 1.67e-2 | tables .99890 1.45e-3
#               mlp .9999928 3.7e-4 | light .99146 1.13e-3
#   flexicubes  deform .9999933 7.5e-4 | msdf .99999911 1.69e-3 | sdf .9999930 1.24e-3
#               cube_weights .999948 1.45e-3 | tables .999935 3.9e-3 | mlp .999972 2.98e-3 | light .99768 3.7e-5
LOSS_RTOL = {"tets": 1.2e-4, "flexicubes": 2e-5}
LIMITS = {
    "tets": {"deform": (0.9899, 2.2e-3), "msdf": (0.99857, 2.2e-3), "sdf": (0.9837, 2.5e-2),
             "tables": (0.99835, 2.2e-3), "mlp": (0.999989, 5.5e-4), "light": (0.9872, 1.7e-3)},
    "flexicubes": {"deform": (0.99999, 1.1e-3), "msdf": (0.9999987, 2.5e-3), "sdf": (0.9999895, 1.9e-3),
                   "cube_weights": (0.999922, 2.2e-3), "tables": (0.999903, 5.8e-3), "mlp": (0.999959, 4.5e-3),
                   "light": (0.9965, 5.6e-5)},
}


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:NV * NB]).reshape(NV, NB), ("view", "band"))


def _jax_setup(kind, denoiser):
    mat = JMatConfig(hash=JHashGridConfig(**HASH), min_max=default_kd_ks_min_max(), **MAT)
    flags = JRenderFlags(raster_backend="xla", max_per_tile=4096, use_denoiser=denoiser, **FLAGS)
    if kind == "tets":
        geo = JGShellGeometry(JGeometryConfig(**GEO[kind]))
    else:
        geo = JGShellFlexiGeometry(JFlexiGeometryConfig(**GEO[kind]))
    st = initial_state(kind)
    params = {k: jnp.asarray(n(v)) for k, v in st["geo"].items()}
    mat_p = init_mlp_texture(jax.random.PRNGKey(1), mat)
    return geo, mat, flags, params, mat_p, n(st["light"])


def _jax_target():
    return {k: jnp.asarray(n(v)) for k, v in target().items()}


def _port_state(rec, params, mat_p, light):
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)
    return convert.state_from_jax(rec, tree(params), tree(mat_p), np.asarray(light), step=STEP)


# ---------------------------------------------------------------- the render


@pytest.fixture(scope="module")
def rendered():
    """JAX's and the port's banded renders of JAX's extracted tets mesh, with
    the per-band draws of JAX's ``keys_vb``; the port's unbanded render
    too, with the ``kd`` BSDF."""
    geo, mat, flags, params, mat_p, light_np = _jax_setup("tets", denoiser=True)
    tg = _jax_target()
    m = geo.extractor(*geo.fields(params), watertight_template=True, compute_aug_normals=False,
                      compute_tangents=False)
    faces, fvalid, _ = j_compact_faces(m.faces, m.face_valid, cap=geo.extractor.max_tets)
    v_nrm = j_auto_normals(m.verts, faces, fvalid)
    light_j = j_update_pdf(jnp.asarray(light_np))
    keys = jax.random.split(jax.random.PRNGKey(2), NV)
    keys_vb = jax.vmap(lambda kk: jax.random.split(kk, NB))(keys)
    if jnp.issubdtype(keys_vb.dtype, jax.dtypes.prng_key):
        keys_vb = jax.random.key_data(keys_vb)

    def j_band(c, k, mvp, campos, bg, res):
        return j_render_mesh(k, m.verts, faces, v_nrm, m.msdf, mat_p, mat, mvp, campos, light_j,
                             flags._replace(resolution=res), background=bg, shadow_scale=0.0, denoiser_sigma=2.0)

    want = jax.jit(lambda kv: j_render_batch_banded(_jax_mesh(), j_band, {}, kv, tg["mvp"], tg["campos"],
                                                    tg["background"], flags.resolution))(keys_vb)
    rec = reconstructor("tets")
    st = _port_state(rec, params, mat_p, light_np)
    verts, faces_t, vn, msdf = (t(x) for x in (m.verts, faces, v_nrm, m.msdf))
    light_t = update_pdf(st.light_base.detach())
    source = lambda kind, name, shape, lo, hi: _draw(kind, view_key_for(*band_key_for(
        keys[int(name.split("/")[0][len("view"):])], name.partition("/")[2], NB)), shape, lo, hi)
    tt = target()

    def port_render(fl):
        def band(cd, mvp, campos, bg, res):
            return render_mesh(cd, verts, faces_t.long(), vn, msdf, st.params_mat, rec.mat_cfg, mvp, campos, light_t,
                               fl._replace(resolution=res), background=bg, shadow_scale=0.0, denoiser_sigma=2.0)
        return band

    with torch.no_grad():
        got = render_batch_banded(port_render(rec.flags), ReplayDraws(source), tt["mvp"], tt["campos"],
                                  tt["background"], rec.flags.resolution, CellGrid(NV, NB))
        kd_flags = rec.flags._replace(bsdf="kd")
        banded_kd = render_batch_banded(port_render(kd_flags), ReplayDraws(source), tt["mvp"], tt["campos"],
                                        tt["background"], kd_flags.resolution, CellGrid(NV, NB))
        src_un = lambda kind, name, shape, lo, hi: _draw(kind, view_key_for(
            keys[int(name.split("/")[0][len("view"):])], name.partition("/")[2]), shape, lo, hi)
        unbanded_kd = [render_mesh(ReplayDraws(src_un).child(f"view{v}"), verts, faces_t.long(), vn, msdf,
                                   st.params_mat, rec.mat_cfg, tt["mvp"][v], tt["campos"][v], light_t, kd_flags,
                                   background=tt["background"][v], shadow_scale=0.0) for v in range(NV)]
    return want, got, banded_kd, unbanded_kd


def test_banded_render_matches_jax(rendered):
    want, got, _, _ = rendered
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        if k == "visible_vert_mask":  # JAX's own rule for a silhouette pixel's flip
            assert (n(got[k]) != np.asarray(want[k])).mean() < 0.005
        elif k in ("n_raster_dropped", "n_px_dropped", "n_px_dropped_second"):
            np.testing.assert_array_equal(n(got[k]).astype(np.int64), np.asarray(want[k]).astype(np.int64), err_msg=k)
        else:
            assert got[k].shape == tuple(want[k].shape), k
            err = np.abs(n(got[k]) - np.asarray(want[k]))
            off = float((err > 1e-4).any(-1).mean())
            if k in EXACT_BUFFERS:
                assert off <= 1e-3, (k, off)
            else:
                assert off <= 0.03 and float(err.mean()) <= 3e-4, (k, off, float(err.mean()))
    assert int(n(got["mask"]).sum()) > 0


def test_banded_render_matches_the_unbanded_one(rendered):
    _, _, banded, unbanded = rendered
    for k in ("shaded", "mask", "msdf_image", "invdepth"):
        a = n(banded[k])[:, 1:-1]
        b = np.stack([n(u[k]) for u in unbanded])[:, 1:-1]
        frac = (np.abs(a - b) > 1e-4).any(-1).mean()
        assert frac < 0.01, f"{k}: {frac:.4%} of the pixels differ"
    vis_want = n(unbanded[0]["visible_vert_mask"]) | n(unbanded[1]["visible_vert_mask"])
    assert (n(banded["visible_vert_mask"][0]) != vis_want).mean() < 0.005


def test_banded_render_rejects_what_does_not_split():
    grid = CellGrid(2, 3)
    tt = target()
    with pytest.raises(ValueError, match="do not split"):
        render_batch_banded(None, None, tt["mvp"], tt["campos"], tt["background"], (RES, RES), grid)
    with pytest.raises(ValueError, match="n_view"):
        render_batch_banded(None, None, tt["mvp"][:1], tt["campos"], tt["background"], (RES, RES), CellGrid(2, 2))


# ---------------------------------------------------------------- the ticks


def _grads(st):
    pg, pm = st.params_geo, st.params_mat
    out = {k: pg[k].grad for k in ("deform", "msdf", "sdf", "cube_weights") if k in pg}
    out.update(tables=pm["tables"].grad, mlp=torch.cat([w.grad.reshape(-1) for w in pm["mlp"]]),
               light=st.light_base.grad)
    return out


def _grads_jax(grads):
    g_geo, g_mat, g_lgt = grads
    out = {k: g_geo[k] for k in ("deform", "msdf", "sdf", "cube_weights") if k in g_geo}
    out.update(tables=g_mat.tables.tables, mlp=np.concatenate([np.asarray(w).reshape(-1) for w in g_mat.mlp]),
               light=g_lgt)
    return out


@pytest.fixture(scope="module", params=["tets", "flexicubes"])
def ticked(request):
    kind = request.param
    geo, mat, flags, params, mat_p, light_np = _jax_setup(kind, denoiser=True)
    tg = _jax_target()
    key = jax.random.PRNGKey(5)
    vis, extra = ("mesh_splat", {"shadow_ko": 4}) if kind == "tets" else (None, {})

    def loss_fn(pg, pm, lb):
        img, depth, reg, aux = geo.tick(key, pg, pm, mat, j_update_pdf(lb), tg, STEP, flags, j_create_loss("logl1"),
                                        visibility_fn=vis, shadow_scale=1.0, denoiser_sigma=2.0,
                                        spatial_mesh=_jax_mesh(), **extra)
        return img + depth + reg, (img, depth, reg, aux)

    rec = reconstructor(kind, spatial=(NV, NB))
    source = train_source(key, BATCH, NB) if kind == "tets" else flexi_train_source(key, BATCH, None, NB)

    def port():
        st = _port_state(rec, params, mat_p, light_np)
        img, depth, reg, aux = rec.geo.tick(ReplayDraws(source), st.params_geo, st.params_mat, rec.mat_cfg,
                                            update_pdf(st.light_base), target(), STEP, rec.flags, rec.image_loss_fn,
                                            use_shadows=kind == "tets", shadow_scale=1.0, denoiser_sigma=2.0,
                                            shadow_ko=4, spatial=rec.spatial)
        (img + depth + reg).backward()
        m_t = {"total": img + depth + reg, "img_loss": img, "depth_loss": depth, "reg_loss": reg, **aux}
        return {k: n(v) for k, v in m_t.items()}, {k: n(v) for k, v in _grads(st).items()}

    (total, (img, depth, reg, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True))(
        params, mat_p, jnp.asarray(light_np))
    m_j = {"total": total, "img_loss": img, "depth_loss": depth, "reg_loss": reg, **aux}
    m_t, g_t = port()
    return kind, m_j, grads, m_t, g_t, jittered_runs(port)


def test_banded_tick_losses_match_jax(ticked):
    kind, m_j, _, m_t, _, _ = ticked
    for k in ("n_faces", "raster_dropped", "px_dropped"):
        assert int(m_t[k]) == int(m_j[k]), k
    assert int(m_t["n_faces"]) > 0
    for k in ("total", "img_loss", "reg_loss"):
        got, want = float(m_t[k]), float(m_j[k])
        assert abs(got - want) <= LOSS_RTOL[kind] * abs(want), (kind, k, got, want)


def test_banded_tick_gradients_match_jax(ticked):
    kind, _, grads_j, _, gt, jittered = ticked
    gj = _grads_jax(grads_j)
    for g in gt:
        assert np.abs(gt[g]).max() > 0, f"{g}: zero gradient"
        assert_cosine_and_norm(gt[g], gj[g], [j[g] for _, j in jittered] if g in ENVELOPED.get(kind, ()) else [],
                               LIMITS[kind][g], what=f"{kind} {g}")


# ---------------------------------------------------------------- two ranks


@pytest.mark.parametrize("kind", ["tets", "flexicubes"])
def test_two_ranks_equal_one_process(kind, tmp_path):
    state = initial_state(kind)
    outs = run_ranks("banded_step", 2, {"kind": kind, "spatial": (NV, NB), "state": state}, tmp_path)
    ref = step_record(*banded_reconstructor(kind, (NV, NB), state))
    a, b = outs
    assert a["metrics"] == b["metrics"]
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    for k in ("total", "img_loss", "reg_loss"):
        assert abs(a["metrics"][k] - ref["metrics"][k]) <= 1e-6 * abs(ref["metrics"][k]), k
    for i, (p, q, g, h, lr) in enumerate(zip(a["params"], ref["params"], a["grads"], ref["grads"], ref["lrs"])):
        assert float((g - h).norm()) <= 5e-6 * float(h.norm()), (i, tuple(g.shape))
        # Adam's first step moves by lr·g/(|g| + ε): a gradient rounded by δ
        # moves it by lr·ε·δ/(|g| + ε)²
        through_adam = 2 * lr * ADAM_EPS * (g - h).abs() / (h.abs() + ADAM_EPS) ** 2
        assert bool(((p - q).abs() <= 1e-6 * (q.abs() + lr) + through_adam).all()), (i, tuple(p.shape))
