"""The port's entry points and working point against the JAX package's.

* ``train_gshell.main`` builds the same geometry config, material config,
  render flags and trainer config as the repository's ``train_gshell.py``
  for every reconstruction config, the benchmark cells' configs and the
  command-line overrides: each ``main`` runs with the geometry and the
  trainer replaced by recorders, which stop it where its ``Reconstructor``
  is built (on the port's side ``reconstructor_from_flags`` itself runs),
  so no lattice is built and no JAX step is compiled.
* ``chip_smoke.py``'s working point (configs, SDF pretrain count, disk
  target) equals what the repository's ``bench.py`` builds at 512,64,8,2,
  recorded the same way up to its first train step.
* The entry points that take ``--device`` refuse to run without a card
  unless told ``--device cpu``.
* Each hand kernel's launch site counts its launches under its key in
  ``utils/kernels.py``.
* The tets extractor (template, cut, tangents, normals) and FlexiCubes at
  res 8, ``pbr_bsdf`` and the gradient of its sum at [1, 16, 16], on the
  same inputs as the JAX functions.  Faces and masks exactly; values to
  1e-5 relative; the smooth normals and the tangents, which amplify the
  float32 round-off of their sums, to the limits below (readings: normals
  1.0e-5 tets and 3.5e-6 FlexiCubes, tangents 2.8e-6).  FlexiCubes rows
  are held where a valid face reads them (unread boundary slots
  extrapolate ν, as in JAX); tangents off the branch cut of the
  orthonormal basis, where a normal's z is within round-off of 0 and its
  sign, which picks the branch, is round-off.
"""
import dataclasses
import importlib
import importlib.util
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import gshell_tpu.geometry.flexi_geometry as jflexi_geometry
import gshell_tpu.geometry.geometry as jgeometry
import gshell_tpu.train.reconstruct as jreconstruct
import gshell_tpu.utils.cache as jcache
from gshell_tpu.geometry.cube_grid import build_cube_grid as j_build_cube_grid
from gshell_tpu.geometry.gshell_flexicubes import GShellFlexiCubes as JGShellFlexiCubes
from gshell_tpu.geometry.gshell_tets import GShellTets as JGShellTets
from gshell_tpu.geometry.tet_grid import build_tet_grid as j_build_tet_grid
from gshell_tpu.ops.bsdf import pbr_bsdf as j_pbr_bsdf
from gshell_tpu.ops.mesh_ops import auto_normals as j_auto_normals
from gshell_tpu_torch import train_gshell
from gshell_tpu_torch.geometry.cube_grid import build_cube_grid
from gshell_tpu_torch.geometry.gshell_flexicubes import GShellFlexiCubes
from gshell_tpu_torch.geometry.gshell_tets import GShellTets
from gshell_tpu_torch.geometry.tet_grid import build_tet_grid
from gshell_tpu_torch.ops import denoiser, gather, rasterize, shade
from gshell_tpu_torch.ops.bsdf import pbr_bsdf
from gshell_tpu_torch.ops.mesh_ops import auto_normals
from gshell_tpu_torch.train import setup
from gshell_tpu_torch.utils import kernels
from torch_parity import assert_close, n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NRM_ATOL = 1e-4
TNG_ATOL = 3e-5
BRANCH_CUT_NZ = 1e-4  # |n_z| within this of 0: the basis's branch is round-off
RECON_CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs"))
                       if f.endswith(".json") and not f.startswith("diffusion_"))
TRAIN_CASES = ([(os.path.join("configs", f), []) for f in RECON_CONFIGS]
               + [(os.path.join("benchmark", "configs", f), [])
                  for f in ("deepfashion_mc_tets128.json", "deepfashion_mc_flexi80.json")]
               + [(os.path.join("configs", "deepfashion_mc.json"), extra)
                  for extra in (["--flexicubes"], ["-b", "4"], ["-i", "3000"], ["--n_samples", "16"])])


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _recorders(seen):
    """(Geometry, FlexiGeometry, Trainer): record what they are built with;
    the trainer stops the caller at its first train step."""

    class Geometry:
        def __init__(self, gcfg, *device):
            seen.update(kind="tets", gcfg=gcfg)

    class FlexiGeometry:
        def __init__(self, gcfg, *device):
            seen.update(kind="flexicubes", gcfg=gcfg)

    class Trainer:
        def __init__(self, geo, mat_cfg, flags, tcfg):
            seen.update(mat_cfg=mat_cfg, flags=flags, tcfg=tcfg)

        def init_state(self, key, pretrain_steps):
            seen["pretrain"] = pretrain_steps

        def train_step(self, state, key, target):
            seen["target"] = target
            raise _Stop

    return Geometry, FlexiGeometry, Trainer


def _without_bench_variables(monkeypatch):
    """The JAX bench's ablation variables unset: its defaults apply."""
    for k in [k for k in os.environ if k.startswith("GSHELL_")]:
        monkeypatch.delenv(k)


def _jax_bench_record(monkeypatch, quick, cfg):
    """What the JAX bench's ``run_config`` builds, up to its first step."""
    seen = {}
    geometry, _, trainer = _recorders(seen)
    monkeypatch.setattr(jgeometry, "GShellGeometry", geometry)
    monkeypatch.setattr(jreconstruct, "Reconstructor", trainer)
    with pytest.raises(_Stop):
        _load("jax_bench", "bench.py").run_config(quick, *cfg)
    return seen


def _jax_train_record(monkeypatch, argv):
    """What the JAX ``train_gshell.main`` builds for ``argv``, up to its
    ``Reconstructor``."""
    seen = {}
    geometry, flexi_geometry, trainer = _recorders(seen)

    def stop(*args):
        trainer(*args)
        raise _Stop

    monkeypatch.setattr(jgeometry, "GShellGeometry", geometry)
    monkeypatch.setattr(jflexi_geometry, "GShellFlexiGeometry", flexi_geometry)
    monkeypatch.setattr(jreconstruct, "Reconstructor", stop)
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["train_gshell.py", *argv])
    with pytest.raises(_Stop):
        _load("jax_train_gshell", "train_gshell.py").main()
    return seen


def _port_train_record(monkeypatch, argv):
    """What the port's ``train_gshell.main`` builds for ``argv`` through
    ``reconstructor_from_flags``, up to its ``Reconstructor``."""
    seen = {}
    geometry, flexi_geometry, trainer = _recorders(seen)

    def stop(*args):
        trainer(*args)
        raise _Stop

    monkeypatch.setattr(setup, "GShellGeometry", geometry)
    monkeypatch.setattr(setup, "GShellFlexiGeometry", flexi_geometry)
    monkeypatch.setattr(setup, "Reconstructor", stop)
    with pytest.raises(_Stop):
        train_gshell.main([*argv, "--device", "cpu"])
    return seen


def _fields(x):
    if hasattr(x, "_fields"):
        return {k: getattr(x, k) for k in x._fields}
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return None


def _assert_shared_equal(port, ref, what):
    """Every field the two configs share is equal (nested configs field by
    field); returns the shared names."""
    a, b = _fields(port), _fields(ref)
    shared = sorted(set(a) & set(b))
    for k in shared:
        if _fields(a[k]) is not None:
            _assert_shared_equal(a[k], b[k], f"{what}.{k}")
        else:
            assert a[k] == b[k], f"{what}.{k}: port {a[k]!r}, JAX {b[k]!r}"
    return shared


def test_chip_smoke_working_point_equals_jax_bench(monkeypatch):
    _without_bench_variables(monkeypatch)
    res, grid, spp, batch = chip_smoke.RES, chip_smoke.GRID, chip_smoke.SPP, chip_smoke.BATCH
    assert (res, grid, spp, batch) == (512, 64, 8, 2)
    want = _jax_bench_record(monkeypatch, False, (res, grid, spp, batch))
    gcfg, mat_cfg, flags, tcfg, pretrain = chip_smoke.working_point_configs()
    shared = _assert_shared_equal(gcfg, want["gcfg"], "GeometryConfig")
    assert {"view_batch_mode", "n_eikonal_samples", "grid_res"} <= set(shared)
    # what the port's config lacks (the extractor's capacity factor) is at JAX's default
    jdefault = type(want["gcfg"])()
    unshared = [k for k in _fields(want["gcfg"]) if k not in shared]
    assert unshared and all(getattr(want["gcfg"], k) == getattr(jdefault, k) for k in unshared), unshared
    _assert_shared_equal(mat_cfg, want["mat_cfg"], "MLPTexture3DConfig")
    shared = _assert_shared_equal(flags, want["flags"], "RenderFlags")
    assert {"bsdf", "use_denoiser", "shade_budget", "jitter_tap_frac", "mc_block", "resolution"} <= set(shared)
    _assert_shared_equal(tcfg, want["tcfg"], "TrainConfig")
    assert pretrain == want["pretrain"]
    target = chip_smoke.disk_target(res, batch, CPU)
    assert set(target) == set(want["target"])
    for k, v in want["target"].items():
        np.testing.assert_array_equal(n(target[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("config, extra", TRAIN_CASES,
                         ids=[" ".join([c, *e]) for c, e in TRAIN_CASES])
def test_train_configs_equal_jax_train_gshell(monkeypatch, tmp_path, config, extra):
    argv = ["--config", os.path.join(ROOT, config), *extra]
    want = _jax_train_record(monkeypatch, argv + ["-o", str(tmp_path / "jax")])
    got = _port_train_record(monkeypatch, argv + ["-o", str(tmp_path / "port")])
    assert got["kind"] == want["kind"]
    shared = _assert_shared_equal(got["gcfg"], want["gcfg"], "GeometryConfig")
    assert {"grid_res", "scale", "mlp", "use_sdf_mlp", "view_batch_mode", "total_iters"} <= set(shared)
    _assert_shared_equal(got["mat_cfg"], want["mat_cfg"], "MLPTexture3DConfig")
    shared = _assert_shared_equal(got["flags"], want["flags"], "RenderFlags")
    assert {"resolution", "n_samples", "spp", "bsdf", "use_denoiser", "shade_budget", "max_pairs"} <= set(shared)
    shared = _assert_shared_equal(got["tcfg"], want["tcfg"], "TrainConfig")
    assert {"lr_pos", "lr_mat", "lr_lgt", "loss", "iters", "batch"} <= set(shared)


@pytest.mark.parametrize("name, argv", [
    ("bake_grids", ["--states", "{tmp}/*.pt", "--out-dir", "{tmp}/baked"]),
    ("main_diffusion", ["--mode", "train", "--workdir", "{tmp}/diffusion"]),
    ("eval_gmeshdiffusion", ["--samples", "{tmp}/*.npz", "--out-dir", "{tmp}/meshes"]),
])
def test_entry_points_refuse_without_a_card(monkeypatch, tmp_path, name, argv):
    """Without ``--device`` they ask for the card; where there is none they
    exit with a message before writing anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"gshell_tpu_torch.{name}")
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([a.format(tmp=tmp_path) for a in argv])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name, module", [
    ("rasterize_stage_b", rasterize), ("bilateral_accumulate", denoiser), ("scatter_rows", gather),
    ("mc_shade_fwd", shade), ("mc_shade_bwd", shade),
])
def test_each_launch_site_counts_under_its_key(name, module):
    """A launch checked as ``name`` (which ``module`` passes to
    ``kernels.check``) counts once under its key and nowhere else; a failed
    launch raises and counts nothing, nor does a launch of a name no site
    of the port gives (a test's probe); ``chip_smoke.zero_launches`` sets
    every count to 0."""
    assert f'"{name}")' in inspect.getsource(module)
    key = kernels.COUNTED_AS[name]
    c0 = kernels.kernel_launches()
    assert list(c0) == ["rasterize_stage_b", "bilateral_accumulate", "gather_rows", "mc_shade"]
    kernels.check(0, name)
    assert kernels.launches_since(c0) == {k: int(k == key) for k in c0}
    with pytest.raises(RuntimeError, match=f"{name}: CUDA launch failed with cudaError 700"):
        kernels.check(700, name)
    assert kernels.launches_since(c0) == {k: int(k == key) for k in c0}
    kernels.check(0, "mc_shade_probe")
    assert kernels.launches_since(c0) == {k: int(k == key) for k in c0}
    if key == "gather_rows":
        assert gather.gather_stats()["launches"] == c0[key] + 1
    chip_smoke.zero_launches()
    assert kernels.kernel_launches() == dict.fromkeys(c0, 0)


def tets_case(res: int, device):
    """(fn, (pos, sdf, msdf)): the full tets extraction at ``res`` on the
    SDF 0.35 − |p| and the mSDF z + 0.05; ``fn`` returns (GShellMesh with
    tangents, the cut mesh's normals)."""
    grid = build_tet_grid(res)
    ex = GShellTets(grid, device)
    pos = torch.as_tensor(grid.verts, device=device)

    def extract(p, s, m):
        mesh = ex(p, s, m, compute_tangents=True)
        return mesh, auto_normals(mesh.verts, mesh.faces, mesh.face_valid)

    return extract, (pos, 0.35 - torch.linalg.norm(pos, dim=-1), pos[:, 2] + 0.05)


def flexicubes_case(res: int, device):
    """(fn, (x, s, nu)): FlexiCubes at ``res`` without weights (training
    split) on |p| − 0.35 (inside-negative) and the mSDF z + 0.05; ``fn``
    returns the FlexiMesh."""
    grid = build_cube_grid(res)
    fc = GShellFlexiCubes(grid, device)
    x = torch.as_tensor(grid.verts, device=device)
    return (lambda p, s, m: fc(p, s, m)), (x, torch.linalg.norm(x, dim=-1) - 0.35, x[:, 2] + 0.05)


def bsdf_inputs(shape, device, seed: int = 0) -> tuple:
    """(kd, arm, pos, nrm, view_pos, light_pos), each ``shape + (3,)``
    uniform in [0, 1), the normals normalized; kd and arm require grad."""
    gen = torch.Generator(device).manual_seed(seed)
    kd, arm, pos, nrm, view, light = (torch.rand(tuple(shape) + (3,), generator=gen, device=device)
                                      for _ in range(6))
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    return kd.requires_grad_(True), arm.requires_grad_(True), pos, nrm, view, light


def bsdf_forward(*args):
    with torch.no_grad():
        return pbr_bsdf(*args)


def bsdf_backward(*args):
    """d sum(pbr_bsdf) / d (kd, arm)."""
    return torch.autograd.grad(pbr_bsdf(*args).sum(), args[:2])


def test_tets_extraction_equals_jax():
    fn, args = tets_case(8, CPU)
    mesh, v_nrm = fn(*args)
    ex = JGShellTets(j_build_tet_grid(8))
    want = jax.jit(lambda p, s, m: ex(p, s, m))(*(jnp.asarray(n(a)) for a in args))
    np.testing.assert_array_equal(n(mesh.faces), np.asarray(want.faces))
    np.testing.assert_array_equal(n(mesh.face_valid), np.asarray(want.face_valid))
    assert int(mesh.face_valid.sum()) > 0 and int(mesh.n_valid_tets) == int(want.n_valid_tets)
    for k in ("verts", "msdf", "msdf_boundary"):
        assert_close(getattr(mesh, k), getattr(want, k), rtol=1e-5, atol=1e-6, what=k)
    assert np.abs(np.asarray(want.msdf_boundary)).max() > 0  # the cut is in the extraction
    assert_close(v_nrm, want.v_nrm, rtol=0.0, atol=NRM_ATOL, what="v_nrm")
    nwt = want.n_verts_watertight
    nz = np.asarray(j_auto_normals(want.verts[:nwt], want.faces_wt, want.face_wt_valid))[:, 2]
    off_cut = np.ones(len(nz) + 4 * ex.max_tets, bool)
    off_cut[:nwt] = np.abs(nz) > BRANCH_CUT_NZ
    assert off_cut[:nwt].mean() > 0.9
    assert_close(n(mesh.v_tng)[off_cut], np.asarray(want.v_tng)[off_cut], rtol=0.0, atol=TNG_ATOL, what="v_tng")


def test_flexicubes_extraction_equals_jax():
    fn, args = flexicubes_case(8, CPU)
    mesh = fn(*args)
    fc = JGShellFlexiCubes(j_build_cube_grid(8))
    want = jax.jit(lambda p, s, m: fc(p, s, m))(*(jnp.asarray(n(a)) for a in args))
    for k in ("faces", "face_valid", "faces_wt", "face_wt_valid"):
        np.testing.assert_array_equal(n(getattr(mesh, k)), np.asarray(getattr(want, k)), err_msg=k)
    assert int(mesh.face_valid.sum()) > 0 and int(mesh.n_surf_cubes) == int(want.n_surf_cubes)
    read = np.zeros(np.shape(want.verts)[0], bool)
    read[: want.n_verts_watertight] = True
    read[np.asarray(want.faces)[np.asarray(want.face_valid)].ravel()] = True
    for k in ("verts", "msdf"):
        assert_close(n(getattr(mesh, k))[read], np.asarray(getattr(want, k))[read], rtol=1e-5, atol=1e-6, what=k)
    b_read = read[want.n_verts_watertight:]
    assert_close(n(mesh.msdf_boundary)[b_read], np.asarray(want.msdf_boundary)[b_read], rtol=1e-5, atol=1e-6,
                 what="msdf_boundary")
    assert_close(mesh.l_dev, want.l_dev, rtol=1e-5, atol=1e-6, what="l_dev")
    assert_close(n(mesh.v_nrm)[read], np.asarray(want.v_nrm)[read], rtol=0.0, atol=NRM_ATOL, what="v_nrm")


def test_pbr_bsdf_and_its_gradient_equal_jax():
    args = bsdf_inputs((1, 16, 16), CPU)
    j_args = tuple(jnp.asarray(n(a)) for a in args)
    assert_close(bsdf_forward(*args), j_pbr_bsdf(*j_args), rtol=1e-5, atol=1e-6, what="pbr_bsdf")
    want = jax.grad(lambda *a: j_pbr_bsdf(*a).sum(), argnums=(0, 1))(*j_args)
    for name, got, w in zip(("d/dkd", "d/darm"), bsdf_backward(*args), want):
        assert_close(got, w, rtol=1e-5, atol=1e-6, what=name)
    assert n(args[3]).shape == (1, 16, 16, 3)
    np.testing.assert_allclose(np.linalg.norm(n(args[3]), axis=-1), 1.0, rtol=1e-6)
