"""Both training ticks of the port with the second layer and depth
supervision on (``use_depth``, ``use_img_2nd_layer``,
``use_depth_2nd_layer``, and a dataset with two layers' targets) against
the JAX package's, on the CPU: the tets tick (grid 12, mesh-splat shadows,
``map_remat``) and the FlexiCubes tick (voxel 10), each at 32², n_samples 2,
batch 2, a small SDF MLP and hash grid, state step 1000, with the JAX draws
replayed (each view's second layer draws from the view's key, split in two,
as JAX's ``render_second_layer`` does).

The JAX state is a pretrained sphere cut open by an mSDF plane, so the
second layer holds the inside; ``convert`` carries it into the port.  The
port peels with stage B's two layers over the tile segments, JAX with its
scan.  Counts (faces, raster and pixel drops) are compared exactly, each
loss term to a relative limit, each gradient group by cosine and relative
norm difference, at limits about 1.5× the CPU readings (``LIMITS``), as
``tests/test_torch_flexi_tick.py`` does: the two extractions differ by
round-off, a few Monte-Carlo samples flip on it, the denoiser spreads each
flip, and the undenoised second layer keeps them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.geometry.flexi_geometry import FlexiGeometryConfig as JFlexiGeometryConfig
from gshell_tpu.geometry.flexi_geometry import GShellFlexiGeometry as JGShellFlexiGeometry
from gshell_tpu.geometry.geometry import GeometryConfig as JGeometryConfig
from gshell_tpu.geometry.geometry import GShellGeometry as JGShellGeometry
from gshell_tpu.geometry.mlp import MLPConfig as JMLPConfig
from gshell_tpu.ops import math as jm
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.ops.image_loss import create_loss as j_create_loss
from gshell_tpu.render.light import update_pdf as j_update_pdf
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu_torch import convert
from gshell_tpu_torch.geometry.flexi_geometry import FlexiGeometryConfig, GShellFlexiGeometry
from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.geometry.mlp import MLPConfig
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.render.material import MLPTexture3DConfig
from gshell_tpu_torch.render.render import RenderFlags
from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_parity import assert_close, cosine_and_norm, flexi_train_source, n, t, train_source

torch.set_num_threads(1)
RES, BATCH, STEP = 32, 2, 1000
MLP = dict(n_freq=4, d_hidden=32, n_hidden=2, skip_in=(1,))
HASH = dict(n_levels=4, log2_table_size=12, base_resolution=4, desired_resolution=64)
SUPERVISION = dict(use_depth=True, use_img_2nd_layer=True, use_depth_2nd_layer=True)
GEO = {"tets": dict(grid_res=12, n_eikonal_samples=512, total_iters=5000, **SUPERVISION),
       "flexicubes": dict(grid_res=10, n_eikonal_samples=512, total_iters=5000, **SUPERVISION)}
MAT = dict(channels=6, internal_dims=16, hidden=2, min_max=default_kd_ks_min_max())
FLAGS = dict(resolution=(RES, RES), n_samples=2, jitter_tap_frac=0.25, mc_block=2, light_bf16=True,
             use_denoiser=True)
TERMS = ("total", "img_loss", "depth_loss", "reg_loss")
GROUPS = {"tets": ("deform", "msdf", "sdf_net", "tables", "mlp", "light"),
          "flexicubes": ("deform", "msdf", "sdf_net", "cube_weights", "tables", "mlp", "light")}
# Loss terms: relative error.  Gradient groups: (cosine ≥, relative norm
# difference ≤).  About 1.5× off the CPU readings:
#   tets        losses: total 4.5e-5, img 3.3e-4, depth 2.3e-6, reg 2.3e-7
#               deform .985791 3.21e-2 | msdf .99999996 4.9e-5 | sdf_net .999975 7.5e-3
#               tables .999242 3.8e-3 | mlp .999893 2.0e-3 | light .988271 5.5e-5
#   flexicubes  losses: total 5.3e-6, img 2.8e-5, depth 2.2e-6, reg 0
#               deform .999476 8.9e-3 | msdf .9999999991 4.6e-6 | sdf_net .999981 4.2e-3
#               cube_weights .999970 7.7e-3 | tables .999367 9.1e-3 | mlp .999947 1.4e-3
#               light .995169 3.4e-3
# With the second layer off the tets deform reads .99903: the layer adds
# flipped samples that no denoiser spreads (its ten largest rows carry 62 %
# of the difference; over the other 99 % of vertices the cosine is .99988).
LOSS_RTOL = {"tets": 5e-4, "flexicubes": 5e-5}
LIMITS = {
    "tets": {"deform": (0.9787, 0.048), "msdf": (0.99999993, 7.4e-5), "sdf_net": (0.99996, 0.0113),
             "tables": (0.99886, 5.8e-3), "mlp": (0.99984, 3e-3), "light": (0.9824, 8.3e-5)},
    "flexicubes": {"deform": (0.99921, 0.0134), "msdf": (0.999999998, 7e-6), "sdf_net": (0.99997, 6.3e-3),
                   "cube_weights": (0.999955, 0.0116), "tables": (0.99905, 0.0137), "mlp": (0.99992, 2.1e-3),
                   "light": (0.99275, 5.2e-3)},
}


def _target():
    mvps, campos = [], []
    for eye in ([0.0, 0.3, 2.5], [1.8, 0.5, 1.6]):
        proj = jm.perspective(np.deg2rad(45.0), 1.0, 0.1, 1000.0)
        view = jm.lookat(jnp.array(eye), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
        mvps.append(np.asarray(proj @ view))
        campos.append(eye)
    ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    r = np.sqrt((xs - RES / 2) ** 2 + (ys - RES / 2) ** 2)
    mask = (r < 0.3 * RES).astype(np.float32)[..., None]
    inner = (r < 0.2 * RES).astype(np.float32)[..., None]
    img = np.concatenate([np.ones((RES, RES, 3), np.float32) * 0.5 * mask, mask], -1)
    img2 = np.concatenate([np.ones((RES, RES, 3), np.float32) * 0.3 * inner, inner], -1)
    two = lambda a: np.stack([a, a]).astype(np.float32)
    return {"mvp": np.stack(mvps).astype(np.float32), "campos": np.array(campos, np.float32),
            "img": two(img), "background": np.zeros((BATCH, RES, RES, 3), np.float32),
            "invdepth": two(0.42 * mask), "img_second": two(img2), "invdepth_second": two(0.36 * inner)}


def _smooth_light():
    y, x = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512), indexing="ij")
    base = 0.5 + 0.2 * np.sin(2 * np.pi * x)[..., None] * np.cos(np.pi * y)[..., None] * np.array([1.0, 0.8, 0.6])
    return base.astype(np.float32)


def _cut(params, verts):
    """The pretrained sphere cut open by the mSDF plane y = 0.25 (its top
    removed), so the views see into it."""
    return {**params, "msdf": jnp.asarray((0.25 - verts[:, 1] + 0.1 * verts[:, 0]).astype(np.float32))}


def _jax_tick(kind):
    mat = JMatConfig(hash=JHashGridConfig(**HASH), **MAT)
    flags = JRenderFlags(raster_backend="xla", max_per_tile=4096, **FLAGS)
    if kind == "tets":
        geo = JGShellGeometry(JGeometryConfig(mlp=JMLPConfig(**MLP), view_batch_mode="map_remat", **GEO[kind]))
        params = geo.pretrain_sdf(geo.init_params(jax.random.PRNGKey(0)), steps=300)
        params = _cut(params, np.asarray(geo.verts))
        vis = "mesh_splat"
    else:
        geo = JGShellFlexiGeometry(JFlexiGeometryConfig(mlp=JMLPConfig(**MLP), **GEO[kind]))
        params = _cut(geo.pretrain_sdf(geo.init_params(jax.random.PRNGKey(0)), steps=300), np.asarray(geo.verts))
        vis = None
    state = {"geo": params, "mat": init_mlp_texture(jax.random.PRNGKey(1), mat), "light": jnp.asarray(_smooth_light())}
    target = {k: jnp.asarray(v) for k, v in _target().items()}
    key = jax.random.PRNGKey(5)
    extra = {"shadow_ko": 16} if kind == "tets" else {}

    def loss_fn(pg, pm, lb):
        img, depth, reg, aux = geo.tick(key, pg, pm, mat, j_update_pdf(lb), target, STEP, flags,
                                        j_create_loss("logl1"), visibility_fn=vis, shadow_scale=1.0,
                                        denoiser_sigma=2.0, **extra)
        return img + depth + reg, (img, depth, reg, aux)

    (total, (img, depth, reg, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True))(
        state["geo"], state["mat"], state["light"])
    return {"total": total, "img_loss": img, "depth_loss": depth, "reg_loss": reg, **aux}, grads, state, key


def _port_tick(kind, state_j, key):
    mlp = MLPConfig(**MLP)
    if kind == "tets":
        geo = GShellGeometry(GeometryConfig(mlp=mlp, view_batch_mode="map_remat", **GEO[kind]), "cpu")
        source = train_source(key, BATCH)
    else:
        geo = GShellFlexiGeometry(FlexiGeometryConfig(mlp=mlp, **GEO[kind]), "cpu")
        source = flexi_train_source(key, BATCH, None)
    rec = Reconstructor(geo, MLPTexture3DConfig(hash=HashGridConfig(**HASH), **MAT), RenderFlags(**FLAGS),
                        TrainConfig(batch=BATCH))
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    st = convert.state_from_jax(rec, np_tree(state_j["geo"]), np_tree(state_j["mat"]), np.asarray(state_j["light"]),
                                step=STEP)
    img, depth, reg, aux = rec.geo.tick(ReplayDraws(source), st.params_geo, st.params_mat, rec.mat_cfg,
                                        update_pdf(st.light_base), {k: t(v) for k, v in _target().items()}, STEP,
                                        rec.flags, rec.image_loss_fn, use_shadows=kind == "tets", shadow_scale=1.0,
                                        denoiser_sigma=2.0)
    (img + depth + reg).backward()
    return {"total": img + depth + reg, "img_loss": img, "depth_loss": depth, "reg_loss": reg, **aux}, st


@pytest.fixture(scope="module", params=["tets", "flexicubes"])
def ticked(request):
    m_j, grads_j, state_j, key = _jax_tick(request.param)
    m_t, st = _port_tick(request.param, state_j, key)
    return request.param, m_j, grads_j, m_t, st


def _grads_port(st):
    pg, pm = st.params_geo, st.params_mat
    out = {"deform": pg["deform"].grad, "msdf": pg["msdf"].grad,
           "sdf_net": torch.cat([p.grad.reshape(-1) for p in pg["sdf_net"]["w"] + pg["sdf_net"]["b"]]),
           "tables": pm["tables"].grad, "mlp": torch.cat([w.grad.reshape(-1) for w in pm["mlp"]]),
           "light": st.light_base.grad}
    if "cube_weights" in pg:
        out["cube_weights"] = pg["cube_weights"].grad
    return out


def _grads_jax(grads):
    g_geo, g_mat, g_lgt = grads
    net = g_geo["sdf_net"]
    out = {"deform": g_geo["deform"], "msdf": g_geo["msdf"],
           "sdf_net": np.concatenate([np.asarray(a).reshape(-1) for a in net["w"] + net["b"]]),
           "tables": g_mat.tables.tables, "mlp": np.concatenate([np.asarray(w).reshape(-1) for w in g_mat.mlp]),
           "light": g_lgt}
    if "cube_weights" in g_geo:
        out["cube_weights"] = g_geo["cube_weights"]
    return out


def test_tick_with_second_layer_and_depth_losses_match_jax(ticked):
    kind, m_j, _, m_t, _ = ticked
    for k in ("n_faces", "raster_dropped", "px_dropped"):
        assert int(m_t[k]) == int(m_j[k]), k
    assert int(m_t["n_faces"]) > 0 and int(m_t["raster_dropped"]) == 0
    assert float(m_t["depth_loss"].detach()) > 0
    for k in TERMS:
        assert_close(m_t[k], m_j[k], rtol=LOSS_RTOL[kind], what=k)


def test_tick_with_second_layer_and_depth_gradients_match_jax(ticked):
    kind, _, grads_j, _, st = ticked
    gt, gj = _grads_port(st), _grads_jax(grads_j)
    for g in GROUPS[kind]:
        assert np.abs(n(gt[g])).max() > 0, f"{g}: zero gradient"
        cos, dnorm = cosine_and_norm(gt[g], gj[g])
        assert cos >= LIMITS[kind][g][0] and dnorm <= LIMITS[kind][g][1], (kind, g, cos, dnorm)
