"""One marching-tets train step of the JAX package and of the port from the
same state and the same (replayed) draws, for ``tests/test_torch_fields.py``
and ``tests/test_torch_legacy_shadows.py``.

A tiny configuration: tet grid 12, 32², n_samples 2, batch 1, a small MLP
and hash grid, the bf16 light texel, the denoiser, state step 1000 (shadows
and denoiser σ = 2 live), ``view_batch_mode`` "map".  The JAX side
rasterizes with the XLA stage B and a per-tile cap above every tile's count
(the port's stage B has none).

JAX's ``Reconstructor.train_step`` returns no gradients, but its first Adam
moments hold them: from zero moments one step leaves mu = (1 − β1)·g, after
the trainer's scaling (hash tables ÷8, light ×64), which is what the port's
``.grad`` holds after its own step.  So one jitted JAX step gives the
losses, the gradients and the updated parameters.  ``step_both`` can hold
both sides to the same branches and measure the port's round-off envelope
(``torch_parity``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gshell_tpu.geometry.geometry import GeometryConfig as JGeometryConfig
from gshell_tpu.geometry.geometry import GShellGeometry as JGShellGeometry
from gshell_tpu.geometry.mlp import MLPConfig as JMLPConfig
from gshell_tpu.geometry.mlp import apply_mlp as j_apply_mlp
from gshell_tpu.ops import math as jm
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu.train.reconstruct import Reconstructor as JReconstructor
from gshell_tpu.train.reconstruct import TrainConfig as JTrainConfig
from gshell_tpu.train.reconstruct import TrainState as JTrainState
from gshell_tpu_torch import convert
from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.geometry.mlp import MLPConfig
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.render.material import MLPTexture3DConfig
from gshell_tpu_torch.render.render import RenderFlags
from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_parity import (assert_close, assert_close_in_envelope, assert_cosine_and_norm, branch_masks,
                          jittered_runs, n, off_branches, t, train_source)

GRID, RES, STEP = 12, 32, 1000
MLP = dict(n_freq=4, d_hidden=32, n_hidden=2, skip_in=(1,))
HASH = dict(n_levels=4, log2_table_size=12, base_resolution=4, desired_resolution=64)
GEO = dict(grid_res=GRID, n_eikonal_samples=512, total_iters=5000, view_batch_mode="map")
MAT = dict(channels=6, internal_dims=16, hidden=2, min_max=default_kd_ks_min_max())
FLAGS = dict(resolution=(RES, RES), n_samples=2, jitter_tap_frac=0.25, mc_block=2, light_bf16=True,
             use_denoiser=True)
TERMS = ("total", "img_loss", "reg_loss", "sdf_reg", "eik_loss", "msdf_reg", "shading_reg")
COUNTS = ("n_valid_tets", "n_faces", "n_crossing_edges", "raster_dropped", "nonfinite_grads")
MARGIN = 0.02  # how far the pretrained SDF's lattice values are pushed off zero


def target():
    proj = jm.perspective(np.deg2rad(45.0), 1.0, 0.1, 1000.0)
    eye = [0.4, 0.3, 2.5]
    view = jm.lookat(jnp.array(eye), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    mask = (np.sqrt((xs - RES / 2) ** 2 + (ys - RES / 2) ** 2) < 0.3 * RES).astype(np.float32)[None, ..., None]
    return {"mvp": np.asarray(proj @ view)[None], "campos": np.array([eye], np.float32),
            "img": np.concatenate([np.ones((1, RES, RES, 3), np.float32) * 0.5 * mask, mask], -1),
            "background": np.zeros((1, RES, RES, 3), np.float32)}


def smooth_light():
    y, x = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512), indexing="ij")
    base = 0.5 + 0.2 * np.sin(2 * np.pi * x)[..., None] * np.cos(np.pi * y)[..., None] * np.array([1.0, 0.8, 0.6])
    return base.astype(np.float32)


def jax_geometry(sdf_mlp: bool, msdf_mlp: bool, lazy: bool = True):
    return JGShellGeometry(JGeometryConfig(mlp=JMLPConfig(**MLP), use_sdf_mlp=sdf_mlp, use_msdf_mlp=msdf_mlp,
                                           lazy_field_grad=lazy, **GEO))


def pretrained_sdf_net(steps: int = 300):
    """JAX's sphere pretrain of the SDF MLP at this size."""
    geo = jax_geometry(True, False)
    return geo.pretrain_sdf(geo.init_params(jax.random.PRNGKey(0)), steps=steps)["sdf_net"]


def jax_params(geo_j, sdf_net=None) -> dict:
    """A JAX geometry state for the field combination of ``geo_j``: the
    pretrained ``sdf_net`` with the lattice pushed MARGIN off its zero level
    by the deformation, or the direct sphere SDF with a small random
    deformation; an mSDF plane, or the mSDF MLP's init with its output
    shifted so that the median lattice vertex sits on the cut."""
    rng = np.random.default_rng(0)
    v = np.asarray(geo_j.verts)
    params = geo_j.init_params(jax.random.PRNGKey(0))
    if "sdf_net" in params:
        params["sdf_net"] = sdf_net
        sdf = np.asarray(j_apply_mlp(sdf_net, jnp.asarray(v), geo_j.cfg.mlp)[:, 0])
        near = np.abs(sdf) < MARGIN
        push = np.where(near, np.where(sdf >= 0, MARGIN, -MARGIN) - sdf, 0.0)
        disp = push[:, None] * v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-6)
        params["deform"] = jnp.asarray(np.clip(disp / geo_j.max_displacement, -1.0, 1.0), jnp.float32)
    else:
        params["deform"] = jnp.asarray(rng.uniform(-0.3, 0.3, v.shape).astype(np.float32))
    if "msdf_net" in params:
        net = params["msdf_net"]
        out = np.asarray(j_apply_mlp(net, jnp.asarray(v), geo_j.cfg.mlp)[:, 0])
        net["b"][-1] = net["b"][-1] - np.float32(np.median(out))
    else:
        plane = 0.3 + v[:, 2] + 0.1 * v[:, 0]
        params["msdf"] = jnp.asarray(np.where(np.abs(plane) < MARGIN, np.where(plane >= 0, MARGIN, -MARGIN), plane),
                                     jnp.float32)
    return params


def _mu_tree(opt_state):
    """The first Adam moment inside an optax state (the one ScaleByAdamState)."""
    found = []

    def visit(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x.mu)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif hasattr(x, "inner_state"):
            visit(x.inner_state)

    visit(opt_state)
    return found


def _flat(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return np.concatenate([np.asarray(a, np.float64).reshape(-1) for a in leaves]) if leaves else None


def jax_gradients(state) -> dict:
    """Gradient groups of a JAX state one step after fresh optimizers."""
    out = {}
    for mu in _mu_tree(state.opt_geo):
        for k, v in mu.items():
            flat = _flat(v)
            if flat is not None:
                out[k] = flat / np.float32(0.1)
    (mu_mat,) = _mu_tree(state.opt_mat)
    out["tables"] = _flat(mu_mat.tables) / np.float32(0.1)
    out["mlp"] = _flat(mu_mat.mlp) / np.float32(0.1)
    (mu_lgt,) = _mu_tree(state.opt_lgt)
    out["light"] = _flat(mu_lgt) / np.float32(0.1)
    return out


def _flat_t(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat_t(x[k])]
    return [t for v in x for t in _flat_t(v)]


def port_gradients(state) -> dict:
    cat = lambda ts: np.concatenate([n(p.grad).astype(np.float64).reshape(-1) for p in ts])
    out = {k: cat(_flat_t(v)) for k, v in state.params_geo.items()}
    out["tables"] = cat([state.params_mat["tables"]])
    out["mlp"] = cat(state.params_mat["mlp"])
    out["light"] = cat([state.light_base])
    return out


def step_both(geo_j, params_geo, tcfg: dict, key=jax.random.PRNGKey(5), same_branches: bool = False,
              jitter: bool = False) -> dict:
    """One JAX and one port train step from ``params_geo`` (a JAX geometry
    state for ``geo_j``) with the JAX draws of ``key`` replayed into the
    port → {metrics_j, metrics_t, grads_j, grads_t, before, after_j,
    after_t, lr_t, jittered} (parameters flattened per geometry group;
    ``lr_t`` the learning rate the port's step took for each geometry
    group).

    With ``same_branches`` both sides' image losses leave out the elements
    whose branch the port's round-off decides (``torch_parity.branch_mask``),
    so that both take the same decisions on what they compare.  With
    ``jitter`` the port's step runs again under each of
    ``torch_parity.ENVELOPE_RUNS`` (``jittered``: their metrics_t, grads_t
    and after_t) for the limits derived from its round-off envelope."""
    mat_j = JMatConfig(hash=JHashGridConfig(**HASH), **MAT)
    rec_j = JReconstructor(geo_j, mat_j, JRenderFlags(raster_backend="xla", max_per_tile=4096, **FLAGS),
                           JTrainConfig(batch=1, **tcfg))
    params_mat, light = init_mlp_texture(jax.random.PRNGKey(1), mat_j), jnp.asarray(smooth_light())
    state_j = JTrainState(params_geo, params_mat, light, rec_j.tx_geo.init(params_geo),
                          rec_j.tx_mat.init(params_mat), rec_j.tx_lgt.init(light), jnp.asarray(STEP, jnp.int32))
    tgt = target()

    g = geo_j.cfg
    geo_t = GShellGeometry(GeometryConfig(mlp=MLPConfig(**MLP), use_sdf_mlp=g.use_sdf_mlp,
                                          use_msdf_mlp=g.use_msdf_mlp, lazy_field_grad=g.lazy_field_grad, **GEO),
                           "cpu")
    mat_t = MLPTexture3DConfig(hash=HashGridConfig(**HASH), **MAT)
    rec_t = Reconstructor(geo_t, mat_t, RenderFlags(**FLAGS), TrainConfig(batch=1, **tcfg))
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    flat_geo = lambda st: {k: np.concatenate([n(p).reshape(-1) for p in _flat_t(v)]) for k, v in st.params_geo.items()}
    loss_t, loss_j = rec_t.image_loss_fn, rec_j.image_loss_fn

    def port(image_loss_fn=loss_t):
        rec_t.image_loss_fn = image_loss_fn
        state_t = convert.state_from_jax(rec_t, np_tree(params_geo), np_tree(params_mat), np.asarray(light),
                                         step=STEP)
        before = flat_geo(state_t)
        lr_t = {k: grp["lr"] for k, grp in zip(state_t.params_geo, state_t.optimizers[0].param_groups)}
        m_t = rec_t.train_step(state_t, ReplayDraws(train_source(key, 1)), {k: t(v) for k, v in tgt.items()})
        return {"metrics_t": {k: n(v) if isinstance(v, torch.Tensor) else v for k, v in m_t.items()},
                "grads_t": port_gradients(state_t), "before": before, "after_t": flat_geo(state_t), "lr_t": lr_t}

    masks = branch_masks(port, loss_t) if same_branches else []
    if masks:
        rec_j.image_loss_fn = off_branches(loss_j, masks, jnp.where)
        run = lambda: port(off_branches(loss_t, masks, torch.where))
    else:
        run = port
    new_j, m_j = rec_j.train_step(state_j, key, {k: jnp.asarray(v) for k, v in tgt.items()})
    out = run()
    out.update(metrics_j={k: np.asarray(v) for k, v in m_j.items()}, grads_j=jax_gradients(new_j),
               after_j={k: _flat(new_j.params_geo[k]) for k in out["before"]},
               jittered=jittered_runs(run) if jitter else [])
    return out


def assert_losses(s, terms, rtol, enveloped=(), atol=1e-7):
    """Each loss term to ``rtol`` / ``atol``; the terms in ``enveloped``
    plus the port's round-off envelope (``torch_parity.assert_close_in_envelope``)."""
    for k in terms:
        jittered = [j["metrics_t"][k] for j in s["jittered"]] if k in enveloped else []
        if jittered:
            assert_close_in_envelope(s["metrics_t"][k], s["metrics_j"][k], jittered, rtol=rtol, atol=atol, what=k)
        else:
            assert_close(s["metrics_t"][k], s["metrics_j"][k], rtol=rtol, atol=atol, what=k)


def assert_gradients(s, limits, enveloped=()):
    """Each gradient group by cosine and relative norm difference at
    ``limits[group]``; the groups in ``enveloped`` at the looser of that and
    the port's round-off envelope (``torch_parity.cosine_and_norm_limits``)."""
    for k, gt in s["grads_t"].items():
        assert np.abs(gt).max() > 0, f"{k}: zero gradient"
        jittered = [j["grads_t"][k] for j in s["jittered"]] if k in enveloped else []
        assert_cosine_and_norm(gt, s["grads_j"][k], jittered, limits[k.replace("_net", "")], what=k)


def update_agreement(s, name: str, lr: float) -> float:
    """The share of a geometry group's elements whose updated value the port
    and JAX agree on to a thousandth of the step (Adam's first step moves
    every element by about ±lr, so an element whose tiny gradient differs
    in sign between the two lands 2·lr apart)."""
    a, b = s["after_t"][name].astype(np.float64), s["after_j"][name]
    return float(np.mean(np.abs(a - b) <= 1e-3 * lr + 1e-6 * np.abs(b)))
