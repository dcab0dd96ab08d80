"""The port's side of the banded-render tests, without JAX (the gloo ranks of
``tests/torch_dist.py`` import it): the sizes of JAX's ``_banded_setup``
(``tests/test_parallel.py``: 64², tet grid 16, two views, n_samples 2, a
4-level hash grid), both geometries with a direct SDF, and a reconstructor
over (view, band) cells."""
from __future__ import annotations

import numpy as np
import torch

RES, BATCH = 64, 2
HASH = dict(n_levels=4, log2_table_size=12, base_resolution=4, desired_resolution=64)
MAT = dict(channels=6, internal_dims=16, hidden=2)
FLAGS = dict(resolution=(RES, RES), n_samples=2, bsdf="pbr", mc_block=2, light_bf16=True, jitter_tap_frac=0.25)
GEO = {"tets": dict(grid_res=16, use_sdf_mlp=False, use_eikonal=False, n_eikonal_samples=512),
       "flexicubes": dict(grid_res=12, use_sdf_mlp=False, use_eikonal=False, n_eikonal_samples=512)}
STEP = 1000  # shadows and the denoiser's sigma live


def views():
    """The two cameras of JAX's ``_banded_setup`` (numpy): 2.5 units out at
    angles 0 and 0.3 rad."""
    from gshell_tpu_torch.ops import math as gm

    proj = gm.perspective(np.deg2rad(45.0), 1.0, 0.1, 1000.0)
    mvps, eyes = [], []
    for i in range(BATCH):
        ang = 0.3 * i
        eye = torch.tensor([2.5 * np.sin(ang), 0.0, 2.5 * np.cos(ang)], dtype=torch.float32)
        mvps.append(proj @ gm.lookat(eye, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0])))
        eyes.append(eye)
    return torch.stack(mvps).float(), torch.stack(eyes)


def target() -> dict:
    """JAX's ``_banded_setup`` target: a 0.3-radius disk of grey."""
    mvp, campos = views()
    ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    r = np.sqrt((xs - RES / 2) ** 2 + (ys - RES / 2) ** 2)
    m = np.repeat((r < 0.3 * RES).astype(np.float32)[None, ..., None], BATCH, 0)
    img = np.concatenate([np.ones((BATCH, RES, RES, 3), np.float32) * 0.5 * m, m], -1)
    return {"mvp": mvp, "campos": campos, "img": torch.from_numpy(img),
            "background": torch.zeros((BATCH, RES, RES, 3))}


def reconstructor(kind: str, spatial=None, denoiser: bool = True, group=None):
    from gshell_tpu_torch.geometry.flexi_geometry import FlexiGeometryConfig, GShellFlexiGeometry
    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max
    from gshell_tpu_torch.render.render import RenderFlags
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig

    if kind == "tets":
        geo = GShellGeometry(GeometryConfig(**GEO[kind]), "cpu")
    else:
        geo = GShellFlexiGeometry(FlexiGeometryConfig(**GEO[kind]), "cpu")
    mat = MLPTexture3DConfig(hash=HashGridConfig(**HASH), min_max=default_kd_ks_min_max(), **MAT)
    return Reconstructor(geo, mat, RenderFlags(use_denoiser=denoiser, **FLAGS), TrainConfig(batch=BATCH, shadow_ko=4),
                         spatial=spatial, group=group)


def initial_state(kind: str, seed: int = 0) -> dict:
    """A seeded initial state, as tensors: the sphere init's direct SDF, a
    small random deformation and an mSDF plane that cuts the sphere's top
    off (``tests/test_torch_fields.py``'s direct-SDF FlexiCubes state, the
    plane tilted so that no two lattice vertices tie: FlexiCubes' cut
    divides by the difference of two dual vertices' mSDF, and near a tie the
    two packages' roundings of it give the regularizers' mSDF gradient
    different sizes)."""
    from gshell_tpu_torch.utils.rng import TorchDraws

    rec = reconstructor(kind)
    st = rec.init_state(TorchDraws(torch.Generator().manual_seed(seed)), pretrain_steps=0)
    pg = {k: v.detach().clone() for k, v in st.params_geo.items()}
    v = (rec.geo.lattice_verts() if kind == "tets" else rec.geo.verts).numpy()
    pg["deform"] = torch.from_numpy(np.random.default_rng(seed).uniform(-0.3, 0.3, v.shape).astype(np.float32))
    pg["msdf"] = torch.from_numpy((0.25 - v[:, 1] + 0.2137 * v[:, 0] + 0.0731 * v[:, 2]).astype(np.float32))
    return {"geo": pg, "mat": {"tables": st.params_mat["tables"].detach().clone(),
                               "mlp": [w.detach().clone() for w in st.params_mat["mlp"]]},
            "light": st.light_base.detach().clone()}


def banded_reconstructor(kind: str, spatial, state: dict, group=None):
    """(reconstructor over ``spatial`` cells, its state at ``STEP``, the
    target, the step's draws)."""
    from gshell_tpu_torch.utils.rng import TorchDraws

    rec = reconstructor(kind, spatial, group=group)
    st = rec.make_state(state["geo"], state["mat"], state["light"], step=STEP)
    return rec, st, target(), TorchDraws(torch.Generator().manual_seed(7))


def step_record(rec, state, target_, draws) -> dict:
    """One train step → its metrics (floats), the parameters after it, the
    gradients the optimizers took (averaged across ranks) and each
    parameter's learning rate in the step."""
    from gshell_tpu_torch.train.reconstruct import _leaves

    groups = (state.params_geo, state.params_mat, [state.light_base])
    lr = {id(p): g["lr"] for o in state.optimizers for g in o.param_groups for p in g["params"]}
    lrs = [lr[id(p)] for p in _leaves(groups)]
    m = rec.train_step(state, draws, target_)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": [p.detach().clone() for p in _leaves(groups)],
            "grads": [p.grad.detach().clone() for p in _leaves(groups)], "lrs": lrs}
