"""The port's reconstruction train step vs the JAX package's, end to end.

A tiny configuration (tet grid 16, 64², n_samples 2, batch 1, small SDF MLP
and hash grid, shadows from the mesh splat, denoiser on, the bf16 light
texel of the main path, state step 1000 so shadows and denoiser are live)
is initialized by the JAX package; ``convert`` carries its state into the
port; both sides take one train step on the same target with the JAX
random draws replayed into the port.  64² rather than 32²: at 32² the shade
budget rounds up to the whole image and foreground compaction would not
run.  The JAX side rasterizes with the XLA stage B and a per-tile cap above
every tile's count (asserted through raster_dropped == 0), which is the
semantics of the port's uncapped stage B.

Two scenes.  ``conditioned`` (draw key 5): the pretrained sphere made well
conditioned (:func:`_well_conditioned`) under a smooth light map.  ``raw``
(draw key 7): the pretrained mesh as it is, under the uniform-noise light
of ``init_state`` — the state a run's first step at step 1000 sees.

Tolerances.  The gradients cannot agree to round-off: the two extractions
evaluate the SDF MLP at the crossing points with another summation order,
so vertices differ by ~5e-7, and a few discrete choices downstream flip on
that difference — the z-test between the two triangles of a folded
marching-tets quad, a shadow-field voxel, a light-CDF bin.  Each flip moves
a whole Monte-Carlo sample (a quarter of a pixel at n_samples 2), and the
denoiser spreads it over its r = 11 window, so the difference sits on a few
rows of each group (the ten largest rows carry 72–97 % of it for deform and
tables).  Each group is held to a cosine and a relative norm difference
over all rows, and again over the 99 % of rows (vertices, table entries,
texels; single weights) that differ least, at limits about 1.5× the
readings in ``LIMITS``, taken on an earlier test host (its CPU model
is not recorded).  On an "AMD EPYC" host the groups named in ``ENVELOPED``
read above them (the raw scene's deform rows 5.1e-3 against 1e-3, its
SDF MLP's cosine .99867 against .99945): at 64² with shadows one ulp of
round-off puts 3.5 % of the image's elements on other branches (a pixel
that moves by more than 1e-3, ``torch_parity.branch_mask``), too many to
leave out of the loss, so those groups are held at the looser of their
limit and 3× the port's round-off envelope, never above 10× the limit
(``torch_parity.cosine_and_norm_limits``).  Given identical inputs the render matches the JAX
function far more tightly; the component tests (raster, denoiser, hash
grid, shading) hold those parts to rtol 1e-5 .. 1e-4.  The abs of the
material taps follows ``jnp.abs``'s derivative at 0 (a fresh hash grid
makes the two taps tie).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gshell_tpu.geometry.geometry import GeometryConfig as JGeometryConfig
from gshell_tpu.geometry.geometry import GShellGeometry as JGShellGeometry
from gshell_tpu.geometry.mlp import MLPConfig as JMLPConfig
from gshell_tpu.ops import math as jm
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.render.light import update_pdf as j_update_pdf
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu.train.reconstruct import Reconstructor as JReconstructor
from gshell_tpu.train.reconstruct import TrainConfig as JTrainConfig
from gshell_tpu_torch import convert
from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.geometry.mlp import MLPConfig
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.render.material import MLPTexture3DConfig
from gshell_tpu_torch.render.render import RenderFlags
from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig, lr_factor
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_parity import assert_close, assert_cosine_and_norm, jittered_runs, n, t, train_source

torch.set_num_threads(1)
GRID, RES = 16, 64
STEP = 1000
MLP = dict(n_freq=4, d_hidden=64, n_hidden=2, skip_in=(1,))
HASH = dict(n_levels=4, log2_table_size=12, base_resolution=4, desired_resolution=64)
GEO = dict(grid_res=GRID, n_eikonal_samples=512, total_iters=5000)
MAT = dict(channels=6, internal_dims=16, hidden=2, min_max=default_kd_ks_min_max())
FLAGS = dict(resolution=(RES, RES), n_samples=2, shade_budget=0.5, jitter_tap_frac=0.25,
             mc_block=2, light_bf16=True, use_denoiser=True)
GROUPS = ("deform", "msdf", "sdf_net", "tables", "mlp", "light")
# group: (cosine ≥, relative norm difference ≤) over all rows, then over the
# 99 % of rows that differ least.  Readings on the CPU, same order:
#   conditioned  deform .998151 6.09e-2 .999779 3.39e-3 | msdf 1.0 1.2e-8 1.0 9.2e-9
#                sdf_net .999957 2.59e-3 .999963 1.37e-3 | tables .999240 2.28e-2 .999992 6.8e-4
#                mlp .999992 1.24e-3 .999993 1.44e-3 | light .988620 1.13e-3 1.0 5.1e-8
#   raw          deform .995375 .150 .999511 6.8e-4 | msdf .998625 8.37e-3 1.0 2.2e-9
#                sdf_net .999631 6.37e-2 .999098 6.21e-2 | tables .998060 1.36e-2 .999917 1.02e-3
#                mlp .999954 1.68e-3 .999968 2.83e-3 | light .983045 1.67e-3 1.0 3.8e-6
LIMITS = {
    "conditioned": {
        "deform": (0.997, 0.09, 0.9996, 5e-3), "msdf": (0.999999, 1e-6, 0.999999, 1e-6),
        "sdf_net": (0.99993, 4e-3, 0.99994, 2e-3), "tables": (0.9988, 0.035, 0.99998, 1e-3),
        "mlp": (0.99998, 2e-3, 0.99998, 2.2e-3), "light": (0.98, 2e-3, 0.999999, 1e-6),
    },
    "raw": {
        "deform": (0.993, 0.22, 0.9992, 1e-3), "msdf": (0.998, 0.013, 0.999999, 1e-6),
        "sdf_net": (0.99945, 0.1, 0.9986, 0.093), "tables": (0.997, 0.02, 0.99987, 1.5e-3),
        "mlp": (0.99993, 2.5e-3, 0.99995, 4.2e-3), "light": (0.974, 2.5e-3, 0.999999, 1e-5),
    },
}
# The groups that on an "AMD EPYC" host (``lscpu``) read above their limits
# by more than the branches of the few samples the limits were set for: held
# at the looser of the limit and 3× the port's round-off envelope, never
# above 10× the limit (the module docstring).
ENVELOPED = {"conditioned": ("light",), "raw": ("deform", "sdf_net", "tables", "mlp", "light")}
# loss rtol per scene (largest reading of img_loss, reg_loss, total: 7.4e-5
# conditioned, 3.2e-4 raw, both the reg_loss)
LOSS_RTOL = {"conditioned": 1e-4, "raw": 5e-4}


def _target():
    proj = jm.perspective(np.deg2rad(45.0), 1.0, 0.1, 1000.0)
    view = jm.lookat(jnp.array([0.0, 0.0, 2.5]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    mask = (np.sqrt((xs - RES / 2) ** 2 + (ys - RES / 2) ** 2) < 0.3 * RES).astype(np.float32)
    mask = mask[None, ..., None]
    return {
        "mvp": np.asarray(proj @ view)[None],
        "campos": np.array([[0.0, 0.0, 2.5]], np.float32),
        "img": np.concatenate([np.ones((1, RES, RES, 3), np.float32) * 0.5 * mask, mask], -1),
        "background": np.zeros((1, RES, RES, 3), np.float32),
    }


def _smooth_light():
    y, x = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512), indexing="ij")
    base = 0.5 + 0.2 * np.sin(2 * np.pi * x)[..., None] * np.cos(np.pi * y)[..., None] * np.array([1.0, 0.8, 0.6])
    return base.astype(np.float32)


MARGIN = 0.02


def _well_conditioned(geo_j, params):
    """The pretrained sphere with every lattice vertex within MARGIN of the
    zero level pushed radially off it (so no surface crossing lies near an
    edge end, and extraction makes no sliver triangles), cut by an mSDF plane
    whose lattice values are kept MARGIN off zero as well."""
    v = np.asarray(geo_j.verts)
    sdf = np.asarray(geo_j.fields_lazy(params)[1])
    near = np.abs(sdf) < MARGIN
    push = np.where(near, np.where(sdf >= 0, MARGIN, -MARGIN) - sdf, 0.0)
    disp = push[:, None] * v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-6)
    deform = np.clip(disp / geo_j.max_displacement, -1.0, 1.0)
    plane = 0.3 + v[:, 2] + 0.1 * v[:, 0]
    msdf = np.where(np.abs(plane) < MARGIN, np.where(plane >= 0, MARGIN, -MARGIN), plane)
    return {**params, "deform": jnp.asarray(deform, jnp.float32), "msdf": jnp.asarray(msdf, jnp.float32)}


def _jax_loss_and_grads(rec, state, key, target):
    """The loss / gradient core of JAX ``Reconstructor.train_step``
    (reconstruct.py:149-212): value_and_grad of the tick, then the
    non-finite-gradient zeroing."""
    tcfg = rec.tcfg
    it = state.step
    shadow_scale = jnp.minimum(it / tcfg.shadow_ramp_iters, 1.0)
    sigma = jnp.maximum(shadow_scale * 2.0, 1e-4)

    def loss_fn(pg, pm, lb):
        img, depth, reg, aux = rec.geo.tick(
            key, pg, pm, rec.mat_cfg, j_update_pdf(lb), target, it, rec.flags, rec.image_loss_fn,
            visibility_fn="mesh_splat", shadow_scale=shadow_scale, denoiser_sigma=sigma,
            shadow_ko=tcfg.shadow_ko,
        )
        return img + depth + reg, (img, reg, aux)

    (total, (img, reg, aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)
    )(state.params_geo, state.params_mat, state.light_base)
    leaves = jax.tree_util.tree_leaves(grads)
    nonfinite = int(sum(jnp.sum(~jnp.isfinite(g)) for g in leaves))
    fix = lambda g: jnp.where(jnp.isfinite(g), g, 0.0)
    return total, img, reg, aux, jax.tree_util.tree_map(fix, grads), nonfinite


@pytest.fixture(scope="module")
def jax_side():
    geo_j = JGShellGeometry(JGeometryConfig(mlp=JMLPConfig(**MLP), view_batch_mode="map", **GEO))
    mat_j = JMatConfig(hash=JHashGridConfig(**HASH), **MAT)
    flags_j = JRenderFlags(raster_backend="xla", max_per_tile=4096, **FLAGS)
    rec_j = JReconstructor(geo_j, mat_j, flags_j, JTrainConfig(batch=1, use_shadows=True))
    state_j = rec_j.init_state(jax.random.PRNGKey(0), pretrain_steps=1000)
    return rec_j, state_j._replace(step=jnp.asarray(STEP, jnp.int32))


def _step_both(rec_j, state_j, key):
    """One train step on each side from the same state and draws, and the
    port's again under each of ``torch_parity.ENVELOPE_RUNS`` (``jittered``:
    their gradients)."""
    target = _target()
    total_j, img_j, reg_j, aux_j, grads_j, nonfinite_j = _jax_loss_and_grads(
        rec_j, state_j, key, {k: jnp.asarray(v) for k, v in target.items()})

    geo_t = GShellGeometry(GeometryConfig(mlp=MLPConfig(**MLP), **GEO), "cpu")
    mat_t = MLPTexture3DConfig(hash=HashGridConfig(**HASH), **MAT)
    rec_t = Reconstructor(geo_t, mat_t, RenderFlags(**FLAGS), TrainConfig(batch=1, use_shadows=True))
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

    def port():
        state_t = convert.state_from_jax(rec_t, np_tree(state_j.params_geo), np_tree(state_j.params_mat),
                                         np.asarray(state_j.light_base), step=STEP)
        metrics = rec_t.train_step(state_t, ReplayDraws(train_source(key, 1)), {k: t(v) for k, v in target.items()})
        return metrics, {k: n(v) for k, v in _port_grads(state_t).items()}

    metrics, grads_t = port()
    return dict(total_j=total_j, img_j=img_j, reg_j=reg_j, aux_j=aux_j, grads_j=grads_j,
                nonfinite_j=nonfinite_j, grads_t=grads_t, metrics=metrics,
                jittered=[g for _, g in jittered_runs(port)])


@pytest.fixture(scope="module")
def stepped(jax_side):
    rec_j, state_j = jax_side
    state_j = state_j._replace(params_geo=_well_conditioned(rec_j.geo, state_j.params_geo),
                               light_base=jnp.asarray(_smooth_light()))
    return _step_both(rec_j, state_j, jax.random.PRNGKey(5))


@pytest.fixture(scope="module")
def stepped_raw(jax_side):
    rec_j, state_j = jax_side
    return _step_both(rec_j, state_j, jax.random.PRNGKey(7))


def _check_loss(s, rtol):
    m, aux_j = s["metrics"], s["aux_j"]
    assert int(aux_j["raster_dropped"]) == 0 and int(m["raster_dropped"]) == 0
    assert int(m["n_faces"]) == int(aux_j["n_faces"]) > 0
    assert int(m["n_valid_tets"]) == int(aux_j["n_valid_tets"])
    assert int(m["px_dropped"]) == int(aux_j["px_dropped"])
    assert np.isfinite(float(m["total"]))
    assert_close(m["img_loss"], s["img_j"], rtol=rtol, what="img_loss")
    assert_close(m["reg_loss"], s["reg_j"], rtol=rtol, what="reg_loss")
    assert_close(m["total"], s["total_j"], rtol=rtol, what="total")


def test_slice_loss_matches_jax(stepped):
    _check_loss(stepped, LOSS_RTOL["conditioned"])


def test_raw_scene_loss_matches_jax(stepped_raw):
    _check_loss(stepped_raw, LOSS_RTOL["raw"])


def _port_grads(state):
    """Raw gradients of the port's step (its optimizer scaled the tables ÷8
    and the light ×64 in place; undo that)."""
    pg, pm = state.params_geo, state.params_mat
    return {
        "deform": pg["deform"].grad,
        "msdf": pg["msdf"].grad,
        "sdf_net": torch.cat([p.grad.reshape(-1) for p in pg["sdf_net"]["w"] + pg["sdf_net"]["b"]]),
        "tables": pm["tables"].grad * 8.0,
        "mlp": torch.cat([w.grad.reshape(-1) for w in pm["mlp"]]),
        "light": state.light_base.grad / 64.0,
    }


def _jax_grads(grads):
    g_geo, g_mat, g_lgt = grads
    net = g_geo["sdf_net"]
    return {
        "deform": g_geo["deform"],
        "msdf": g_geo["msdf"],
        "sdf_net": np.concatenate([np.asarray(a).reshape(-1) for a in net["w"] + net["b"]]),
        "tables": g_mat.tables.tables,
        "mlp": np.concatenate([np.asarray(w).reshape(-1) for w in g_mat.mlp]),
        "light": g_lgt,
    }


def _check_group(s, scene, group):
    gt, gj = s["grads_t"][group], _jax_grads(s["grads_j"])[group]
    assert np.abs(gt).max() > 0, f"{group}: zero gradient"
    limits = LIMITS[scene][group]
    jittered = [g[group] for g in s["jittered"]] if group in ENVELOPED[scene] else []
    assert_cosine_and_norm(gt, gj, jittered, limits[:2], what=group)
    # off the few rows that a flip moves, the gradients agree tightly
    a, b = _rows(gt, group), _rows(gj, group)
    diff = np.linalg.norm(a - b, axis=1)
    keep = np.argsort(diff)[: len(diff) - len(diff) // 100]
    assert_cosine_and_norm(a[keep], b[keep], [_rows(j, group)[keep] for j in jittered], limits[2:],
                           what=f"{group} (99 % of rows)")


@pytest.mark.parametrize("group", GROUPS)
def test_slice_gradients_match_jax(stepped, group):
    _check_group(stepped, "conditioned", group)


@pytest.mark.parametrize("group", GROUPS)
def test_raw_scene_gradients_match_jax(stepped_raw, group):
    _check_group(stepped_raw, "raw", group)


def _rows(g, group):
    """One row per vertex, table entry or light texel; one per weight else."""
    g = n(g).astype(np.float64)
    return g.reshape(g.shape[0], -1) if group == "deform" else g.reshape(-1, g.shape[-1]) \
        if group in ("tables", "light") else g.reshape(-1, 1)


def test_slice_nonfinite_count_matches_jax(stepped):
    assert int(stepped["metrics"]["nonfinite_grads"]) == stepped["nonfinite_j"]


def test_raw_scene_nonfinite_count_matches_jax(stepped_raw):
    """Both sides count 0 at this size; where the count is not 0 the
    non-finite gradients come from the same samples on both sides
    (``test_vndf_nonfinite_gradients_match_jax``)."""
    assert int(stepped_raw["metrics"]["nonfinite_grads"]) == stepped_raw["nonfinite_j"]


def test_adam_schedule_matches_optax():
    """torch Adam(eps=1e-8) + LambdaLR(10^(−0.0002·count)) == optax adam on
    the same schedule: same eps placement, same bias correction.  atol 2e-6:
    optax forms 1 − β₂ᵗ in f32 (β₂ = 0.999 rounds to 0.99900001), torch in
    double, so v̂ differs by 1.3e-5 and each update of size lr = 0.03 by
    6.4e-6 relative, ≤ 2e-7 a step, ≤ 1.2e-6 after the six steps.  The
    1e-9 gradient column sits under eps: eps inside the square root, or
    before the bias correction, would move it by orders of magnitude."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(7,)).astype(np.float32)
    grads = rng.normal(size=(6, 7)).astype(np.float32) * np.array([1e-9, 1e-3, 1, 10, 1, 1, 1], np.float32)
    tx = optax.adam(lambda c: 0.03 * 10.0 ** (-c * 0.0002), eps=1e-8)
    pj, sj = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    pt = t(p0, True)
    opt = torch.optim.Adam([pt], lr=0.03, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_factor)
    for g in grads:
        upd, sj = tx.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = t(g)
        opt.step()
        sched.step()
        assert_close(pt, pj, rtol=1e-5, atol=2e-6, what="adam params")


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gshell_tpu_torch\n"
        "for m in pkgutil.walk_packages(gshell_tpu_torch.__path__, 'gshell_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('gshell_tpu_torch')]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
