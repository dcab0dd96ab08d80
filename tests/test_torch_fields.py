"""The port's geometry fields against the JAX package's: a direct per-vertex
SDF or an SDF MLP, a direct mSDF or an mSDF MLP, for marching tets (every
combination, and the SDF MLP with ``lazy_field_grad=False``) and FlexiCubes
(a direct SDF; ``use_msdf_mlp``, which there keeps a direct mSDF stepped at
lr_pos·1e-2).

Tets: one ``Reconstructor.train_step`` of each package from the same state
with the JAX draws replayed into the port (``torch_train_step``): the loss
terms and counts, every gradient group (read back from JAX's first Adam
moments), and the updated parameters, whose step size is each group's
learning rate.  Without an MLP the extraction is the same arithmetic on
both sides, and the gradients differ only where the Monte-Carlo shading
and the denoiser spread a few round-off flips; with an MLP the two
evaluate it in another summation order, so the crossing points differ by
~1e-7 and a few more samples flip (``tests/test_torch_slice.py``).  Limits
are about 1.5× off the CPU readings listed beside them, taken on an
earlier test host (its CPU model is not recorded).

On an "AMD EPYC" host (``lscpu``) the direct, SDF-MLP and both-MLP steps
took other branches than JAX on a few pixels (a Monte-Carlo sample, a
light texel: a pixel's value jumps by a share of itself where the rest move
by ~1e-6), and most of the both-MLP deform group's norm sits on one
lattice vertex, whose gradient the two sides put 0.062 apart.  Those
steps hold both sides to the same branches: the image elements whose
branch the port's round-off decides leave both image losses
(``torch_parity.branch_mask``: a pixel that one ulp of round-off moves by
more than 1e-3, or an element within 3 round-off envelopes of the loss's
clamp at 0; at most 1 % of them).  What the port's own round-off still moves by more than a limit
allows is named in ``ENVELOPED`` and ``ROUND_OFF_ROWS``: the former at
the looser of the limit and 3× the port's round-off envelope, never above
10× the limit (``torch_parity.cosine_and_norm_limits``), the latter off
the fewest vertices whose envelope carries it (``rows_off_round_off``, at
most 1 %), at the limit.  Every other comparison keeps its limit.

FlexiCubes: JAX's trainer cannot run (ROADMAP C), so the direct-SDF tick
is held against JAX's ``GShellFlexiGeometry.tick`` called directly (no
shadows), and the port's step under ``use_msdf_mlp`` against an optax
composition of JAX's groups with the mSDF at lr_pos·1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_train_step as ts
from gshell_tpu.geometry.flexi_geometry import FlexiGeometryConfig as JFlexiGeometryConfig
from gshell_tpu.geometry.flexi_geometry import GShellFlexiGeometry as JGShellFlexiGeometry
from gshell_tpu.geometry.mlp import MLPConfig as JMLPConfig
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.ops.image_loss import create_loss
from gshell_tpu.render.light import update_pdf as j_update_pdf
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import init_mlp_texture
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
from gshell_tpu_torch.utils.rng import ReplayDraws, TorchDraws
from torch_parity import (assert_close, assert_cosine_and_norm, assert_rows_off_round_off, flexi_train_source,
                          jittered_runs, n, t)

torch.set_num_threads(1)

# name: (use_sdf_mlp, use_msdf_mlp, lazy_field_grad)
COMBOS = {"direct": (False, False, True), "direct_sdf_msdf_mlp": (False, True, True),
          "sdf_mlp": (True, False, True), "both_mlp": (True, True, True), "sdf_mlp_eager": (True, False, False)}
# Loss terms, relative error; the largest reading of each combination:
# direct 1.38e-3 (shading_reg), direct_sdf_msdf_mlp 2.76e-5, sdf_mlp 2.05e-6,
# both_mlp 7.48e-6, sdf_mlp_eager 2.05e-6 (img_loss).
LOSS_RTOL = {"direct": 2e-3, "direct_sdf_msdf_mlp": 5e-5, "sdf_mlp": 4e-6, "both_mlp": 1.5e-5, "sdf_mlp_eager": 4e-6}
# Gradient group: (cosine ≥, relative norm difference ≤).  Readings (cosine,
# difference), same order:
#   direct          deform .9999791 1.64e-4 | msdf 1.0 3.68e-9 | sdf .9999928 2.16e-5
#                   tables .9999863 2.11e-4 | mlp .9999769 1.52e-3 | light .9988475 2.14e-4
#   direct_sdf_     deform .9999977 2.96e-4 | msdf_net 1.0 4.48e-4 | sdf .9999894 7.36e-5
#   msdf_mlp        tables .9999736 6.78e-4 | mlp .9999702 1.55e-3 | light .9995025 8.95e-4
#   sdf_mlp         deform .9999996 6.92e-4 | msdf 1.0 2.13e-7 | sdf_net 1.0 1.06e-5
#   (and _eager)    tables .9999925 8.28e-4 | mlp .9999937 1.61e-3 | light .9992922 9.15e-5
#   both_mlp        deform .9999988 .0182 | msdf_net .9999999 9.8e-4 | sdf_net .9999764 .0237
#                   tables 1.0 4.52e-5 | mlp .9999995 2.48e-4 | light .9974787 6.72e-4
_SDF_MLP = {"deform": (0.9999994, 1.05e-3), "msdf": (0.9999999, 3.2e-7), "sdf": (0.9999999, 1.6e-5),
            "tables": (0.999989, 1.25e-3), "mlp": (0.99999, 2.4e-3), "light": (0.99894, 1.4e-4)}
LIMITS = {
    "direct": {"deform": (0.99997, 2.5e-4), "msdf": (0.9999999, 1e-8), "sdf": (0.99999, 3.3e-5),
               "tables": (0.99998, 3.2e-4), "mlp": (0.99996, 2.3e-3), "light": (0.9983, 3.2e-4)},
    "direct_sdf_msdf_mlp": {"deform": (0.999996, 4.5e-4), "msdf": (0.9999999, 6.7e-4), "sdf": (0.999984, 1.1e-4),
                            "tables": (0.99996, 1e-3), "mlp": (0.999955, 2.3e-3), "light": (0.99925, 1.35e-3)},
    "sdf_mlp": _SDF_MLP, "sdf_mlp_eager": _SDF_MLP,
    "both_mlp": {"deform": (0.999998, 0.027), "msdf": (0.9999998, 1.5e-3), "sdf": (0.999965, 0.036),
                 "tables": (0.9999999, 6.8e-5), "mlp": (0.9999992, 3.7e-4), "light": (0.99622, 1e-3)},
}
# The share of each geometry group's elements updated alike; the least
# reading .98617 (both_mlp's sdf_net), the others ≥ .9977.
UPDATE_AGREEMENT = 0.979
# The steps held to the same branches, and what of them the port's round-off
# envelope limits (the module docstring): gradient groups, loss terms, and
# the groups compared off the rows that carry the envelope.
SAME_BRANCHES = ("direct", "sdf_mlp", "sdf_mlp_eager", "both_mlp")
ENVELOPED = {"direct": ("sdf",), "sdf_mlp": ("sdf_net",), "sdf_mlp_eager": ("sdf_net",), "both_mlp": ("tables",)}
LOSS_ENVELOPED = {"both_mlp": ("shading_reg",)}
ROUND_OFF_ROWS = {"both_mlp": ("deform",)}


@pytest.fixture(scope="module")
def sdf_net():
    return ts.pretrained_sdf_net()


@pytest.fixture(scope="module", params=list(COMBOS))
def stepped(request, sdf_net):
    name = request.param
    geo_j = ts.jax_geometry(*COMBOS[name])
    return name, ts.step_both(geo_j, ts.jax_params(geo_j, sdf_net), {}, same_branches=name in SAME_BRANCHES,
                              jitter=name in ENVELOPED)


def test_tets_step_losses_and_counts_match_jax(stepped):
    name, s = stepped
    m_t, m_j = s["metrics_t"], s["metrics_j"]
    for k in ts.COUNTS:
        assert int(m_t[k]) == int(m_j[k]), (k, m_t[k], m_j[k])
    assert int(m_t["n_faces"]) > 0 and int(m_t["nonfinite_grads"]) == 0
    ts.assert_losses(s, ts.TERMS, LOSS_RTOL[name], LOSS_ENVELOPED.get(name, ()))
    sdf_mlp = COMBOS[name][0]
    assert (float(m_t["eik_loss"]) > 0) == sdf_mlp  # the eikonal runs with an SDF MLP only
    assert ("sdf_net_grad_norm" in m_t) == sdf_mlp


def test_tets_step_gradients_match_jax(stepped):
    name, s = stepped
    sdf_mlp, msdf_mlp, _ = COMBOS[name]
    assert sorted(s["grads_t"]) == sorted(s["grads_j"])
    assert ("sdf_net" if sdf_mlp else "sdf") in s["grads_t"] and ("msdf_net" if msdf_mlp else "msdf") in s["grads_t"]
    rows = ROUND_OFF_ROWS.get(name, ())
    ts.assert_gradients({**s, "grads_t": {k: v for k, v in s["grads_t"].items() if k not in rows}}, LIMITS[name],
                        ENVELOPED.get(name, ()))
    for k in rows:  # per lattice vertex
        assert np.abs(s["grads_t"][k]).max() > 0, f"{k}: zero gradient"
        assert_rows_off_round_off(s["grads_t"][k].reshape(-1, 3), s["grads_j"][k].reshape(-1, 3),
                                  [j["grads_t"][k].reshape(-1, 3) for j in s["jittered"]], LIMITS[name][k], what=k)


def test_tets_step_updates_each_group_at_its_learning_rate(stepped):
    """Adam's first step moves each element by about ±lr of its group: the
    largest move of every geometry group, on both sides, is that lr
    (deform lr_pos; msdf lr_pos, or lr_pos·1e-2 under use_msdf_mlp; sdf
    lr_pos·1e-2); and the port lands where JAX does on most elements."""
    name, s = stepped
    _, msdf_mlp, _ = COMBOS[name]
    lr_pos = TrainConfig().lr_pos
    want = {"deform": lr_pos, "msdf": lr_pos * (1e-2 if msdf_mlp else 1.0), "sdf": lr_pos * 1e-2}
    for k, before in s["before"].items():
        lr = want[k.replace("_net", "")]
        assert s["lr_t"][k] == pytest.approx(lr, rel=1e-12), k  # the port's group took this lr
        for side in ("after_t", "after_j"):
            assert np.abs(s[side][k] - before).max() == pytest.approx(lr, rel=1e-3), (k, side)
        share = ts.update_agreement(s, k, lr)
        assert share >= UPDATE_AGREEMENT, (k, share)


def test_tets_fields_with_gradients_match_jax(sdf_net):
    """``fields`` (every combination) and ``sdf_lattice`` against JAX's."""
    for name, (sdf_mlp, msdf_mlp, _) in COMBOS.items():
        geo_j = ts.jax_geometry(sdf_mlp, msdf_mlp)
        pj = ts.jax_params(geo_j, sdf_net)
        geo_t = GShellGeometry(GeometryConfig(mlp=MLPConfig(**ts.MLP), use_sdf_mlp=sdf_mlp, use_msdf_mlp=msdf_mlp,
                                              **ts.GEO), "cpu")
        pt = convert.params_geo_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
        for got, want, what in zip(geo_t.fields(pt), geo_j.fields(pj), ("v_def", "sdf", "msdf")):
            assert_close(got, want, rtol=1e-5, atol=2e-6, what=f"{name} {what}")
        assert_close(geo_t.sdf_lattice(pt), geo_j.sdf_lattice(pj), rtol=1e-5, atol=2e-6, what=f"{name} lattice")


def test_direct_sdf_skips_the_pretrain_and_clamps_only_what_exists():
    geo = GShellGeometry(GeometryConfig(grid_res=8, use_sdf_mlp=False, use_msdf_mlp=True,
                                        mlp=MLPConfig(**ts.MLP)), "cpu")
    rec = Reconstructor(geo, MLPTexture3DConfig(hash=HashGridConfig(**ts.HASH), **ts.MAT), RenderFlags(**ts.FLAGS))
    state = rec.init_state(TorchDraws(torch.Generator().manual_seed(0)), pretrain_steps=5)
    assert sorted(state.params_geo) == ["deform", "msdf_net", "sdf"]
    assert geo.pretrain_sdf(state.params_geo, None) is state.params_geo
    with torch.no_grad():
        state.params_geo["deform"].fill_(3.0)
    geo.clamp_params(state.params_geo)  # no direct mSDF: nothing else to clamp
    assert float(state.params_geo["deform"].detach().max()) == 1.0


# ---------------- FlexiCubes ----------------

VOXEL = 8
FLEXI_GEO = dict(grid_res=VOXEL, n_eikonal_samples=512, total_iters=5000)
GROUPS_FLEXI = ("deform", "msdf", "sdf", "cube_weights", "tables", "mlp", "light")
FLEXI_LOSS_RTOL = 1e-4
# (cosine ≥, relative norm difference ≤); readings: deform .9999999967 4.42e-5 |
# msdf .9999999972 9.97e-5 | sdf .9999999990 2.61e-5 | cube_weights .9999999949
# 2.05e-5 | tables .99999999972 4.65e-7 | mlp .99999999997 1.17e-6 | light
# .9991967 4.24e-6
FLEXI_LIMITS = {"deform": (0.999999995, 6.6e-5), "msdf": (0.999999995, 1.5e-4), "sdf": (0.9999999984, 4e-5),
                "cube_weights": (0.999999992, 3.1e-5), "tables": (0.9999999995, 7e-7),
                "mlp": (0.99999999995, 1.8e-6), "light": (0.9988, 6.4e-6)}
FLEXI_ENVELOPED = ("tables",)


@pytest.fixture(scope="module")
def flexi_state():
    geo = JGShellFlexiGeometry(JFlexiGeometryConfig(mlp=JMLPConfig(**ts.MLP), use_sdf_mlp=False, **FLEXI_GEO))
    mat = JMatConfig(hash=JHashGridConfig(**ts.HASH), **ts.MAT)
    rng = np.random.default_rng(0)
    v = np.asarray(geo.verts)
    params = geo.init_params(jax.random.PRNGKey(0))
    params = {**params,
              "cube_weights": jnp.asarray(rng.normal(0.0, 0.5, (geo.grid.n_cubes, 21)).astype(np.float32)),
              "deform": jnp.asarray(rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)),
              "msdf": jnp.asarray((0.25 - v[:, 1] + 0.2 * v[:, 0]).astype(np.float32))}
    return geo, mat, {"geo": params, "mat": init_mlp_texture(jax.random.PRNGKey(1), mat),
                      "light": jnp.asarray(ts.smooth_light())}


def _flexi_rec(sdf_mlp: bool, msdf_mlp: bool):
    geo = GShellFlexiGeometry(FlexiGeometryConfig(mlp=MLPConfig(**ts.MLP), use_sdf_mlp=sdf_mlp,
                                                  use_msdf_mlp=msdf_mlp, **FLEXI_GEO), "cpu")
    return Reconstructor(geo, MLPTexture3DConfig(hash=HashGridConfig(**ts.HASH), **ts.MAT), RenderFlags(**ts.FLAGS),
                         TrainConfig(batch=1))


def test_flexi_direct_sdf_init_matches_jax(flexi_state):
    geo_j = flexi_state[0]
    geo_t = _flexi_rec(False, False).geo
    got = geo_t.init_params(TorchDraws(torch.Generator().manual_seed(0)))
    want = geo_j.init_params(jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want) == ["cube_weights", "deform", "msdf", "sdf"]
    np.testing.assert_array_equal(n(got["sdf"]), np.asarray(want["sdf"]))
    assert geo_t.pretrain_sdf(got) is got


def test_flexi_direct_sdf_tick_matches_jax(flexi_state):
    """The groups of ``FLEXI_ENVELOPED`` at the looser of their limit and 3×
    the port's round-off envelope, never above 10× the limit (the module
    docstring).  Held to the same branches as the tets steps, the tables
    group moves no nearer and the light group reads a relative norm
    difference of 1.1e-5 (limit 6.4e-6), so this tick is not."""
    geo_j, mat_j, state_j = flexi_state
    tgt = ts.target()
    key = jax.random.PRNGKey(5)
    flags_j = JRenderFlags(raster_backend="xla", max_per_tile=4096, **ts.FLAGS)
    rec = _flexi_rec(False, False)
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

    def port():
        st = convert.state_from_jax(rec, np_tree(state_j["geo"]), np_tree(state_j["mat"]),
                                    np.asarray(state_j["light"]), step=ts.STEP)
        img, depth, reg, aux = rec.geo.tick(ReplayDraws(flexi_train_source(key, 1, key)), st.params_geo,
                                            st.params_mat, rec.mat_cfg, update_pdf(st.light_base),
                                            {k: t(v) for k, v in tgt.items()}, ts.STEP, rec.flags, rec.image_loss_fn,
                                            use_shadows=False, shadow_scale=1.0, denoiser_sigma=2.0)
        (img + depth + reg).backward()
        m_t = {"total": img + depth + reg, "img_loss": img, "reg_loss": reg, **aux}
        pg, pm = st.params_geo, st.params_mat
        grads = {**{k: pg[k].grad for k in ("deform", "msdf", "sdf", "cube_weights")}, "tables": pm["tables"].grad,
                 "mlp": torch.cat([w.grad.reshape(-1) for w in pm["mlp"]]), "light": st.light_base.grad}
        return {k: n(v) for k, v in m_t.items()}, {k: n(v) for k, v in grads.items()}

    def loss_fn(pg, pm, lb):
        img, depth, reg, aux = geo_j.tick(key, pg, pm, mat_j, j_update_pdf(lb), {k: jnp.asarray(v) for k, v in
                                          tgt.items()}, ts.STEP, flags_j, create_loss("logl1"),
                                          shadow_scale=1.0, denoiser_sigma=2.0)
        return img + depth + reg, (img, reg, aux)

    (total_j, (img_j, reg_j, aux_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2),
                                                                           has_aux=True))(
        state_j["geo"], state_j["mat"], state_j["light"])
    m_t, port_g = port()
    jittered = [g for _, g in jittered_runs(port)]
    m_j = {"total": total_j, "img_loss": img_j, "reg_loss": reg_j, **aux_j}
    for k in ("n_surf_cubes", "n_faces", "raster_dropped"):
        assert int(m_t[k]) == int(m_j[k]), k
    assert int(m_t["n_faces"]) > 0 and float(m_t["eik_loss"]) == 0.0 == float(m_j["eik_loss"])
    for k in ("total", "img_loss", "reg_loss", "l_dev", "sdf_reg", "msdf_reg", "shading_reg"):
        assert_close(m_t[k], m_j[k], rtol=FLEXI_LOSS_RTOL, atol=1e-7, what=k)
    g_geo, g_mat, g_lgt = grads_j
    jaxg = {**{k: g_geo[k] for k in ("deform", "msdf", "sdf", "cube_weights")}, "tables": g_mat.tables.tables,
            "mlp": np.concatenate([np.asarray(w).reshape(-1) for w in g_mat.mlp]), "light": g_lgt}
    for k in GROUPS_FLEXI:
        assert np.abs(port_g[k]).max() > 0, k
        assert_cosine_and_norm(port_g[k], jaxg[k], [g[k] for g in jittered] if k in FLEXI_ENVELOPED else [],
                               FLEXI_LIMITS[k], what=k)


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_np_tree(v) for v in x]
    return n(x).copy()


@pytest.mark.parametrize("sdf_mlp, msdf_mlp", [(False, False), (False, True), (True, True)])
def test_flexi_train_step_matches_an_optax_composition(flexi_state, sdf_mlp, msdf_mlp):
    """The port's FlexiCubes step against optax given the port's gradients:
    JAX's geometry groups in order (deform with cube_weights at lr_pos; the
    direct mSDF at lr_pos, or lr_pos·1e-2 under use_msdf_mlp, as JAX's
    trainer sets it; sdf / sdf_net at lr_pos·1e-2) and the clamps."""
    _, _, state_j = flexi_state
    rec = _flexi_rec(sdf_mlp, msdf_mlp)
    pg0 = rec.geo.init_params(TorchDraws(torch.Generator().manual_seed(0)))
    pg0 = rec.geo.pretrain_sdf(pg0, steps=200)
    for k in ("deform", "cube_weights", "msdf"):
        pg0[k] = t(state_j["geo"][k])
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    st = rec.make_state(pg0, convert.params_mat_from_jax(np_tree(state_j["mat"]), "cpu"), t(state_j["light"]),
                        step=ts.STEP)
    p0 = jax.tree_util.tree_map(jnp.asarray, _np_tree(st.params_geo))
    m = rec.train_step(st, ReplayDraws(flexi_train_source(jax.random.PRNGKey(6), 1, jax.random.PRNGKey(12))),
                       {k: t(v) for k, v in ts.target().items()})
    assert all(np.isfinite(float(m[k])) for k in ("total", "img_loss", "reg_loss")) and int(m["n_faces"]) > 0
    assert ("sdf_net_grad_norm" in m) == sdf_mlp
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(n(p.grad)), st.params_geo,
                                   is_leaf=lambda x: isinstance(x, torch.Tensor))
    lr_pos = rec.tcfg.lr_pos
    sched = lambda lr: (lambda c: lr * 10.0 ** (-c * 0.0002))
    group = lambda lr, names: optax.masked(optax.adam(sched(lr), eps=1e-8),
                                           lambda p: {k: jax.tree_util.tree_map(lambda _: k in names, v)
                                                      for k, v in p.items()})
    tx = optax.chain(group(lr_pos, {"deform", "cube_weights"}), group(lr_pos * (1e-2 if msdf_mlp else 1.0), {"msdf"}),
                     group(lr_pos * 1e-2, {"sdf", "sdf_net"}))
    new = optax.apply_updates(p0, tx.update(grads, tx.init(p0), p0)[0])
    new["deform"] = jnp.clip(new["deform"], -1.0, 1.0)
    new["msdf"] = jnp.clip(new["msdf"], -2.0, 2.0)
    for k in st.params_geo:
        for a, b in zip(jax.tree_util.tree_leaves(_np_tree(st.params_geo[k])), jax.tree_util.tree_leaves(new[k])):
            assert_close(a, b, rtol=1e-5, atol=2e-6, what=k)
    moved = np.abs(n(st.params_geo["msdf"]) - np.asarray(p0["msdf"])).max()
    assert moved == pytest.approx(lr_pos * (1e-2 if msdf_mlp else 1.0), rel=1e-3)
