"""The port's FlexiCubes training path vs the JAX package's, at voxel 12,
32², n_samples 2, batch 2 (two cameras), a small SDF MLP and hash grid, the
bf16 light texel, state step 1000 (shadows and denoiser σ = 2 live).

The JAX state is a pretrained sphere with random per-cube weights, a small
random deformation and an mSDF plane that cuts it open; ``convert`` carries
it into the port.  ``GShellFlexiGeometry.tick`` of both packages runs on the
same target with the JAX draws replayed into the port, once without shadows
and once with the cut mesh's splat occluder: the port's tick builds it
itself, and the JAX tick, which cannot (ROADMAP C), is handed the same
occluder built here from the JAX cut mesh with the same key.

Counts (surface cubes, faces, raster drops) are compared exactly, each loss
term to ``LOSS_RTOL``, and each gradient group (deform, msdf, sdf_net,
cube_weights, tables, mlp, light) by cosine and relative norm difference
at limits about 1.5× the readings, as ``tests/test_torch_slice.py`` does:
the two extractions differ by round-off (``tests/test_torch_flexicubes.py``),
a few Monte-Carlo samples flip on it, and the denoiser spreads each flip.

One ``Reconstructor.train_step`` of the port is held against an optax
composition built here from the JAX trainer's groups with ``cube_weights``
in the ``deform`` group (Adam at lr_pos); and the JAX trainer's own
``tx_geo`` is shown to pass ``cube_weights``' raw gradient through as its
update (the JAX fault the port does not copy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gshell_tpu.geometry.flexi_geometry import FlexiGeometryConfig as JFlexiGeometryConfig
from gshell_tpu.geometry.flexi_geometry import GShellFlexiGeometry as JGShellFlexiGeometry
from gshell_tpu.geometry.geometry import GShellGeometry as JGShellGeometry
from gshell_tpu.geometry.mlp import MLPConfig as JMLPConfig
from gshell_tpu.ops import math as jm
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.ops.mesh_ops import compact_faces as j_compact_faces
from gshell_tpu.ops.shade import make_shadow_field_parts
from gshell_tpu.render.light import update_pdf as j_update_pdf
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu.train.reconstruct import Reconstructor as JReconstructor
from gshell_tpu.train.reconstruct import TrainConfig as JTrainConfig
from gshell_tpu_torch import convert
from gshell_tpu_torch.geometry.flexi_geometry import FlexiGeometryConfig, GShellFlexiGeometry
from gshell_tpu_torch.geometry.mlp import MLPConfig
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.render.material import MLPTexture3DConfig
from gshell_tpu_torch.render.render import RenderFlags
from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_parity import assert_close, cosine_and_norm, flexi_train_source, n, t

torch.set_num_threads(1)
VOXEL, RES, BATCH, STEP = 12, 32, 2, 1000
MLP = dict(n_freq=4, d_hidden=32, n_hidden=2, skip_in=(1,))
HASH = dict(n_levels=4, log2_table_size=12, base_resolution=4, desired_resolution=64)
GEO = dict(grid_res=VOXEL, n_eikonal_samples=512, total_iters=5000)
MAT = dict(channels=6, internal_dims=16, hidden=2, min_max=default_kd_ks_min_max())
FLAGS = dict(resolution=(RES, RES), n_samples=2, jitter_tap_frac=0.25, mc_block=2, light_bf16=True,
             use_denoiser=True)
GROUPS = ("deform", "msdf", "sdf_net", "cube_weights", "tables", "mlp", "light")
TERMS = ("img_loss", "reg_loss", "l_dev", "sdf_reg", "eik_loss", "msdf_reg", "shading_reg")
# Loss terms: relative error, the largest reading (shading_reg) 1.58e-4
# plain, 1.53e-3 shadowed.  Gradient groups: (cosine ≥, relative norm
# difference ≤), about 1.5× off the CPU readings, same order:
#   plain     deform .998643 2.87e-2 | msdf .9999998 9.06e-4 | sdf_net .999936 2.83e-2
#             cube_weights .999686 4.35e-3 | tables .996401 6.81e-3 | mlp .999946 2.93e-4
#             light .995913 7.78e-5
#   shadowed  deform .957320 7.88e-2 | msdf .9999997 7.18e-4 | sdf_net .997881 .108
#             cube_weights .995058 7.08e-3 | tables .995803 4.51e-3 | mlp .999943 5.74e-4
#             light .996949 7.67e-5
LOSS_RTOL = {"plain": 2.5e-4, "shadowed": 2.5e-3}
LIMITS = {
    "plain": {"deform": (0.998, 0.043), "msdf": (0.9999997, 1.4e-3), "sdf_net": (0.9999, 0.043),
              "cube_weights": (0.99953, 6.5e-3), "tables": (0.9946, 0.0102), "mlp": (0.99992, 4.4e-4),
              "light": (0.9939, 1.2e-4)},
    "shadowed": {"deform": (0.936, 0.12), "msdf": (0.99999955, 1.1e-3), "sdf_net": (0.9968, 0.16),
                 "cube_weights": (0.9926, 0.0106), "tables": (0.9937, 6.8e-3), "mlp": (0.99991, 8.6e-4),
                 "light": (0.9954, 1.15e-4)},
}


def _target():
    mvps, campos = [], []
    for eye in ([0.0, 0.3, 2.5], [1.8, 0.5, 1.6]):
        proj = jm.perspective(np.deg2rad(45.0), 1.0, 0.1, 1000.0)
        view = jm.lookat(jnp.array(eye), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
        mvps.append(np.asarray(proj @ view))
        campos.append(eye)
    ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    mask = (np.sqrt((xs - RES / 2) ** 2 + (ys - RES / 2) ** 2) < 0.3 * RES).astype(np.float32)[..., None]
    img = np.concatenate([np.ones((RES, RES, 3), np.float32) * 0.5 * mask, mask], -1)
    return {"mvp": np.stack(mvps).astype(np.float32), "campos": np.array(campos, np.float32),
            "img": np.stack([img, img]), "background": np.zeros((BATCH, RES, RES, 3), np.float32)}


def _smooth_light():
    y, x = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512), indexing="ij")
    base = 0.5 + 0.2 * np.sin(2 * np.pi * x)[..., None] * np.cos(np.pi * y)[..., None] * np.array([1.0, 0.8, 0.6])
    return base.astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    """(JAX geometry, material config, render flags, the JAX state as numpy)."""
    geo = JGShellFlexiGeometry(JFlexiGeometryConfig(mlp=JMLPConfig(**MLP), **GEO))
    mat = JMatConfig(hash=JHashGridConfig(**HASH), **MAT)
    flags = JRenderFlags(raster_backend="xla", max_per_tile=4096, **FLAGS)
    params = geo.pretrain_sdf(geo.init_params(jax.random.PRNGKey(0)), steps=1000)
    rng = np.random.default_rng(0)
    v = np.asarray(geo.verts)
    params = {**params,
              "cube_weights": jnp.asarray(rng.normal(0.0, 0.5, (geo.grid.n_cubes, 21)).astype(np.float32)),
              "deform": jnp.asarray(rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)),
              "msdf": jnp.asarray((0.25 - v[:, 1] + 0.2 * v[:, 0]).astype(np.float32))}
    return geo, mat, flags, {"geo": params, "mat": init_mlp_texture(jax.random.PRNGKey(1), mat),
                             "light": jnp.asarray(_smooth_light())}


def _jax_occluder(geo, params, key):
    """The JAX tets tick's mesh-splat occluder (``geometry.py:388-402``),
    built from the JAX FlexiCubes cut mesh as the port's tick builds its own."""
    mesh = geo.get_mesh(params)
    faces_c, fvalid_c, _ = j_compact_faces(mesh.faces, mesh.face_valid, cap=4 * geo.extractor.max_edges)
    occ, amin, asz = JGShellGeometry.splat_occupancy(geo, key, mesh.verts, faces_c, fvalid_c)
    return make_shadow_field_parts(occ, amin, asz, ko=16)


def _jax_tick(geo, mat, flags, state, target, key, shadowed):
    splat_key = jax.random.PRNGKey(11)

    def loss_fn(pg, pm, lb):
        vis = _jax_occluder(geo, jax.lax.stop_gradient(pg), splat_key) if shadowed else None
        img, depth, reg, aux = geo.tick(key, pg, pm, mat, j_update_pdf(lb), target, STEP, flags,
                                        _jax_loss_fn(), visibility_fn=vis, shadow_scale=1.0,
                                        denoiser_sigma=2.0)
        return img + depth + reg, (img, reg, aux)

    (total, (img, reg, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True))(
        state["geo"], state["mat"], state["light"])
    return {"total": total, "img_loss": img, "reg_loss": reg, **aux}, grads, splat_key


def _jax_loss_fn():
    from gshell_tpu.ops.image_loss import create_loss

    return create_loss("logl1")


def _port_rec():
    geo = GShellFlexiGeometry(FlexiGeometryConfig(mlp=MLPConfig(**MLP), **GEO), "cpu")
    mat = MLPTexture3DConfig(hash=HashGridConfig(**HASH), **MAT)
    return Reconstructor(geo, mat, RenderFlags(**FLAGS), TrainConfig(batch=BATCH))


def _port_state(rec, state):
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return convert.state_from_jax(rec, np_tree(state["geo"]), np_tree(state["mat"]), np.asarray(state["light"]),
                                  step=STEP)


def _both(jax_side, shadowed, key=jax.random.PRNGKey(5)):
    geo_j, mat_j, flags_j, state_j = jax_side
    target = _target()
    m_j, grads_j, splat_key = _jax_tick(geo_j, mat_j, flags_j, state_j, {k: jnp.asarray(v) for k, v in target.items()},
                                        key, shadowed)
    rec = _port_rec()
    st = _port_state(rec, state_j)
    draws = ReplayDraws(flexi_train_source(key, BATCH, splat_key))
    img, depth, reg, aux = rec.geo.tick(draws, st.params_geo, st.params_mat, rec.mat_cfg, update_pdf(st.light_base),
                                        {k: t(v) for k, v in target.items()}, STEP, rec.flags, rec.image_loss_fn,
                                        use_shadows=shadowed, shadow_scale=1.0, denoiser_sigma=2.0)
    (img + depth + reg).backward()
    m_t = {"total": img + depth + reg, "img_loss": img, "reg_loss": reg, **aux}
    return m_j, grads_j, m_t, st


@pytest.fixture(scope="module")
def plain(jax_side):
    return _both(jax_side, shadowed=False)


@pytest.fixture(scope="module")
def shadowed(jax_side):
    return _both(jax_side, shadowed=True)


def _group_grads_port(st):
    pg, pm = st.params_geo, st.params_mat
    return {"deform": pg["deform"].grad, "msdf": pg["msdf"].grad, "cube_weights": pg["cube_weights"].grad,
            "sdf_net": torch.cat([p.grad.reshape(-1) for p in pg["sdf_net"]["w"] + pg["sdf_net"]["b"]]),
            "tables": pm["tables"].grad, "mlp": torch.cat([w.grad.reshape(-1) for w in pm["mlp"]]),
            "light": st.light_base.grad}


def _group_grads_jax(grads):
    g_geo, g_mat, g_lgt = grads
    net = g_geo["sdf_net"]
    return {"deform": g_geo["deform"], "msdf": g_geo["msdf"], "cube_weights": g_geo["cube_weights"],
            "sdf_net": np.concatenate([np.asarray(a).reshape(-1) for a in net["w"] + net["b"]]),
            "tables": g_mat.tables.tables, "mlp": np.concatenate([np.asarray(w).reshape(-1) for w in g_mat.mlp]),
            "light": g_lgt}


def readings(s):
    m_j, grads_j, m_t, st = s
    gt, gj = _group_grads_port(st), _group_grads_jax(grads_j)
    return {g: cosine_and_norm(gt[g], gj[g]) for g in GROUPS}


def _check_losses(s, scene):
    m_j, _, m_t, _ = s
    for k in ("n_surf_cubes", "n_faces", "raster_dropped"):
        assert int(m_t[k]) == int(m_j[k]), k
    assert int(m_t["n_faces"]) > 0 and int(m_t["raster_dropped"]) == 0
    for k in ("cube_slot_overflow", "edge_slot_overflow", "face_cap_overflow"):
        assert int(m_t[k]) == 0, k
    for k in ("total",) + TERMS:
        assert_close(m_t[k], m_j[k], rtol=LOSS_RTOL[scene], what=k)


def test_flexi_tick_losses_match_jax(plain):
    _check_losses(plain, "plain")


def test_flexi_tick_with_shadows_losses_match_jax(shadowed):
    _check_losses(shadowed, "shadowed")
    assert int(shadowed[2]["splat_cells"]) > 0


@pytest.mark.parametrize("group", GROUPS)
def test_flexi_tick_gradients_match_jax(plain, group):
    cos, dnorm = readings(plain)[group]
    assert np.abs(n(_group_grads_port(plain[3])[group])).max() > 0, f"{group}: zero gradient"
    assert cos >= LIMITS["plain"][group][0] and dnorm <= LIMITS["plain"][group][1], (group, cos, dnorm)


@pytest.mark.parametrize("group", GROUPS)
def test_flexi_tick_with_shadows_gradients_match_jax(shadowed, group):
    cos, dnorm = readings(shadowed)[group]
    assert cos >= LIMITS["shadowed"][group][0] and dnorm <= LIMITS["shadowed"][group][1], (group, cos, dnorm)


def _leaf_np(x):
    return x.detach().numpy().copy()


def test_flexi_train_step_matches_an_optax_composition(jax_side):
    """The port's step: Adam with ``cube_weights`` beside ``deform`` at lr_pos,
    ``msdf`` at lr_pos, ``sdf_net`` at lr_pos·1e-2; tables ÷8, light ×64; the
    clamps.  optax, given the port's own gradients, lands on the same
    parameters."""
    geo_j, mat_j, flags_j, state_j = jax_side
    rec = _port_rec()
    st = _port_state(rec, state_j)
    pg0 = {k: _leaf_np(v) for k, v in st.params_geo.items() if k != "sdf_net"}
    net0 = {k: [_leaf_np(w) for w in v] for k, v in st.params_geo["sdf_net"].items()}
    mat0 = {"tables": _leaf_np(st.params_mat["tables"]), "mlp": [_leaf_np(w) for w in st.params_mat["mlp"]]}
    light0 = _leaf_np(st.light_base)
    key = jax.random.PRNGKey(6)
    m = rec.train_step(st, ReplayDraws(flexi_train_source(key, BATCH, jax.random.PRNGKey(12))),
                       {k: t(v) for k, v in _target().items()})
    assert all(np.isfinite(float(m[k])) for k in ("total", "img_loss", "reg_loss"))
    assert int(m["n_surf_cubes"]) > 0 and int(m["n_faces"]) > 0 and int(m["cube_slot_overflow"]) == 0

    # the gradients the port stepped on (its optimizer scaled tables and light in place)
    pg, pm = st.params_geo, st.params_mat
    g_geo = {k: n(v.grad) for k, v in pg.items() if k != "sdf_net"}
    g_geo["sdf_net"] = {k: [n(w.grad) for w in v] for k, v in pg["sdf_net"].items()}
    p_geo = {**{k: jnp.asarray(v) for k, v in pg0.items()}, "sdf_net": jax.tree_util.tree_map(jnp.asarray, net0)}
    tc = rec.tcfg
    sched = lambda lr: (lambda c: lr * 10.0 ** (-c * 0.0002))
    group = lambda lr, names: optax.masked(optax.adam(sched(lr), eps=1e-8),
                                           lambda p: {k: jax.tree_util.tree_map(lambda _: k in names, v)
                                                      for k, v in p.items()})
    tx_geo = optax.chain(group(tc.lr_pos, {"deform", "cube_weights"}), group(tc.lr_pos, {"msdf"}),
                         group(tc.lr_pos * 1e-2, {"sdf_net"}))
    upd, _ = tx_geo.update(jax.tree_util.tree_map(jnp.asarray, g_geo), tx_geo.init(p_geo), p_geo)
    new_geo = optax.apply_updates(p_geo, upd)
    new_geo["deform"] = jnp.clip(new_geo["deform"], -1.0, 1.0)
    new_geo["msdf"] = jnp.clip(new_geo["msdf"], -2.0, 2.0)
    for k in ("deform", "cube_weights", "msdf"):
        assert_close(pg[k], new_geo[k], rtol=1e-5, atol=2e-6, what=k)
    for a, b in zip(pg["sdf_net"]["w"] + pg["sdf_net"]["b"], new_geo["sdf_net"]["w"] + new_geo["sdf_net"]["b"]):
        assert_close(a, b, rtol=1e-5, atol=2e-8, what="sdf_net")
    # cube_weights took an Adam step of lr_pos (not its raw gradient)
    moved = np.abs(n(pg["cube_weights"]) - pg0["cube_weights"])
    assert moved.max() == pytest.approx(tc.lr_pos, rel=1e-4)

    g_mat = {"tables": n(pm["tables"].grad) * 8.0, "mlp": [n(w.grad) for w in pm["mlp"]]}
    tx_mat = optax.adam(sched(tc.lr_mat), eps=1e-8)
    p_mat = jax.tree_util.tree_map(jnp.asarray, mat0)
    g_mat = jax.tree_util.tree_map(jnp.asarray, {**g_mat, "tables": g_mat["tables"] / 8.0})
    new_mat = optax.apply_updates(p_mat, tx_mat.update(g_mat, tx_mat.init(p_mat), p_mat)[0])
    assert_close(pm["tables"], new_mat["tables"], rtol=1e-5, atol=2e-7, what="tables")
    for a, b in zip(pm["mlp"], new_mat["mlp"]):
        assert_close(a, b, rtol=1e-5, atol=2e-7, what="mlp")
    tx_lgt = optax.chain(optax.scale(64.0), optax.adam(sched(rec.lr_lgt), eps=1e-8))
    g_lgt = jnp.asarray(n(st.light_base.grad) / 64.0)
    new_light = jnp.clip(optax.apply_updates(jnp.asarray(light0), tx_lgt.update(
        g_lgt, tx_lgt.init(jnp.asarray(light0)), jnp.asarray(light0))[0]), min=1e-4)
    assert_close(st.light_base, new_light, rtol=1e-5, atol=2e-6, what="light")


def test_jax_tx_geo_hands_cube_weights_their_raw_gradient(jax_side):
    """The JAX fault (``gshell_tpu/train/reconstruct.py:105-111``): ``cube_weights``
    falls in none of ``tx_geo``'s masks, and ``optax.masked`` passes an
    unmasked leaf's gradient through as its update — gradient ascent at step
    size 1, where ``deform`` takes an Adam step of −lr_pos."""
    geo_j, mat_j, flags_j, state_j = jax_side
    rec = JReconstructor(geo_j, mat_j, flags_j, JTrainConfig(batch=BATCH))
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 5.0), state_j["geo"])
    upd, _ = rec.tx_geo.update(grads, rec.tx_geo.init(state_j["geo"]), state_j["geo"])
    np.testing.assert_array_equal(np.asarray(upd["cube_weights"]), 5.0)
    np.testing.assert_allclose(np.asarray(upd["deform"]), -0.03, rtol=1e-5)


def test_jax_flexi_train_step_raises_on_shadow_ko(jax_side):
    """The JAX fault (``reconstruct.py:176-191`` against ``flexi_geometry.py:125-127``):
    the trainer passes ``shadow_ko=`` to a tick that takes none, so the first
    step of ``train_gshell.py --flexicubes`` fails."""
    geo_j, mat_j, flags_j, state_j = jax_side
    rec = JReconstructor(geo_j, mat_j, flags_j, JTrainConfig(batch=BATCH))
    state = rec.init_state(jax.random.PRNGKey(0), pretrain_steps=0)
    with pytest.raises(TypeError, match="shadow_ko"):
        rec.train_step(state, jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in _target().items()})


def test_port_sdf_lattice_matches_jax(jax_side):
    geo_j, _, _, state_j = jax_side
    rec = _port_rec()
    st = _port_state(rec, state_j)
    assert_close(rec.geo.sdf_lattice(st.params_geo), geo_j.sdf_lattice(state_j["geo"]), rtol=1e-5, atol=1e-6,
                 what="sdf_lattice")
