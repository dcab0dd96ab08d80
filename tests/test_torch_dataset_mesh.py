"""``DatasetMesh`` of the port against the JAX package's: the ground truth
rendered from a reference mesh at 48², 2 views, a small hash grid, with the
JAX draws replayed (``PRNGKey(191)`` for the shadow splat, ``PRNGKey(i)``
for view i), without and with the mesh's own shadow field.  The JAX side
rasterizes with the XLA stage B and a per-tile cap above every tile's count,
the semantics of the port's uncapped stage B.

Cameras (``mvp``, ``campos``) agree to 1e-5 (4.8e-7 measured).  Images: the
two sides build the view matrix and the mesh normals with another summation
order (~5e-7); coverage agrees (the antialiased alpha to 3.5e-4, 2.3e-4
measured on the silhouette), but a Monte-Carlo sample of
one pixel flips on that round-off and the denoiser spreads it over a few
pixels.  Each scene is held to the mean and max absolute difference over
the RGBA images and the count of pixels off by more than 1e-3, about 1.5x
off the readings (``LIMITS``)."""
import os

import jax
import numpy as np
import pytest
import torch

from gshell_tpu.data.datasets import DatasetMesh as JDatasetMesh
from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
from gshell_tpu.render.light import create_trainable_env_rnd as j_env_rnd
from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
from gshell_tpu.render.mesh import load_obj as j_load_obj
from gshell_tpu.render.mesh import unit_size as j_unit_size
from gshell_tpu.render.render import RenderFlags as JRenderFlags
from gshell_tpu_torch import convert
from gshell_tpu_torch.data.datasets import DatasetMesh
from gshell_tpu_torch.ops.hashgrid import HashGridConfig
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.render.material import MLPTexture3DConfig
from gshell_tpu_torch.render.mesh import load_obj, unit_size
from gshell_tpu_torch.render.render import RenderFlags
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_parity import _draw, assert_close, n, view_key_for

torch.set_num_threads(1)
RES = 48
HASH = dict(n_levels=4, log2_table_size=10)
FLAGS = dict(resolution=(RES, RES), n_samples=2, bsdf="pbr", use_denoiser=True)
VIEWS = dict(n_views=2, seed=5, cam_radius=2.5)
# (mean |diff|, max |diff|, pixels off by > 1e-3) per scene; readings on the
# CPU: free 3.58e-6 / 1.11e-2 / 5, shadowed 3.21e-6 / 7.02e-3 / 5 (all five
# in view 1, the same pixels in both scenes).
LIMITS = {False: (5.5e-6, 0.017, 8), True: (5e-6, 0.011, 8)}


def _bowl(path):
    """Deep open bowl: strong self-shadowing (as tests/test_datasets.py)."""
    nu, nv = 24, 10
    lines = []
    for i in range(nv + 1):
        th = 0.5 * np.pi * (0.35 + 0.65 * i / nv)
        for j in range(nu):
            ph = 2 * np.pi * j / nu
            lines.append("v %f %f %f" % (np.sin(th) * np.cos(ph), -np.cos(th), np.sin(th) * np.sin(ph)))
    for i in range(nv):
        for j in range(nu):
            a, b = i * nu + j + 1, i * nu + (j + 1) % nu + 1
            c, d = (i + 1) * nu + (j + 1) % nu + 1, (i + 1) * nu + j + 1
            lines += [f"f {a} {b} {c}", f"f {a} {c} {d}"]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _gt_source(render_seed: int = 0):
    """Replay of the JAX DatasetMesh's draws by the port's draw names."""
    def source(kind, name, shape, lo, hi):
        top, _, rest = name.partition("/")
        if top == "splat":
            k_face, k_uv = jax.random.split(jax.random.PRNGKey(191))
            key = k_face if rest == "face" else k_uv
        else:
            key = view_key_for(jax.random.PRNGKey(int(top[len("view"):]) + 7919 * render_seed), rest)
        return _draw(kind, key, shape, lo, hi)
    return source


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("bowl"), "bowl.obj")
    _bowl(path)
    mat_j = JMatConfig(channels=6, hash=JHashGridConfig(**HASH), min_max=default_kd_ks_min_max())
    params_j = init_mlp_texture(jax.random.PRNGKey(43), mat_j)
    light_j = j_env_rnd(jax.random.PRNGKey(42), 32)
    mat_t = MLPTexture3DConfig(channels=6, hash=HashGridConfig(**HASH), min_max=default_kd_ks_min_max())
    return dict(
        mesh_j=j_unit_size(j_load_obj(path)), mat_j=mat_j, params_j=params_j, light_j=light_j,
        mesh_t=unit_size(load_obj(path)), mat_t=mat_t, params_t=convert.params_mat_from_jax(params_j, "cpu"),
        light_t=update_pdf(torch.as_tensor(np.array(light_j.base))),
    )


def _datasets(scene, shadows: bool):
    kw = dict(VIEWS, shadows=shadows, shadow_grid_res=33)
    ds_j = JDatasetMesh(scene["mesh_j"], scene["light_j"], scene["params_j"], scene["mat_j"],
                        JRenderFlags(raster_backend="xla", max_per_tile=4096, **FLAGS), **kw)
    ds_t = DatasetMesh(scene["mesh_t"], scene["light_t"], scene["params_t"], scene["mat_t"],
                       RenderFlags(**FLAGS), draws=ReplayDraws(_gt_source()), **kw)
    return ds_t, ds_j


@pytest.mark.parametrize("shadows", [False, True], ids=["free", "shadowed"])
def test_dataset_mesh_matches_jax(scene, shadows):
    ds_t, ds_j = _datasets(scene, shadows)
    assert_close(ds_t.mvp, ds_j.mvp, rtol=1e-5, atol=1e-5, what="mvp")
    assert_close(ds_t.campos, ds_j.campos, rtol=1e-5, atol=1e-5, what="campos")
    a, b = n(ds_t.imgs).astype(np.float64), np.asarray(ds_j.imgs, np.float64)
    assert a.shape == b.shape == (2, RES, RES, 4)
    assert (b[..., 3] > 0.5).mean() > 0.05, "the bowl is in view"
    err = np.abs(a - b)
    mean_lim, max_lim, n_lim = LIMITS[shadows]
    n_off = int((err.max(-1) > 1e-3).sum())
    assert err.mean() <= mean_lim and err.max() <= max_lim and n_off <= n_lim, (err.mean(), err.max(), n_off)
    assert_close(a[..., 3], b[..., 3], rtol=0, atol=3.5e-4, what="alpha (coverage)")


def test_dataset_mesh_shadowed_gt_darker(scene):
    """Shadowed ground truth is darker on the foreground than shadow-free
    ground truth of the same scene, views and draws (the port's twin of
    ``tests/test_datasets.py::test_dataset_mesh_shadowed_gt_darker``)."""
    kw = dict(VIEWS, shadow_grid_res=33)
    rf = RenderFlags(**{**FLAGS, "use_denoiser": False})
    args = (scene["mesh_t"], scene["light_t"], scene["params_t"], scene["mat_t"], rf)
    free = DatasetMesh(*args, draws=ReplayDraws(_gt_source()), **kw)
    shad = DatasetMesh(*args, draws=ReplayDraws(_gt_source()), shadows=True, **kw)
    fg = free.imgs[..., 3:] > 0.5
    mean_free = float((free.imgs[..., :3] * fg).sum() / fg.sum())
    mean_shad = float((shad.imgs[..., :3] * fg).sum() / fg.sum())
    assert np.isfinite(mean_free) and np.isfinite(mean_shad)
    assert mean_shad < mean_free * 0.98, (mean_shad, mean_free)
    cov = shad.splat_coverage
    assert 0 <= cov["splat_singletons"] <= cov["splat_cells"] and cov["splat_cells"] > 0
    assert cov["splat_cells"] * cov["splat_samples_per_cell"] == pytest.approx(1 << 17)

