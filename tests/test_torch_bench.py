"""The port's measurement entry points (``gshell_tpu_torch.bench``,
``.bench_extract``, ``.bench_diffusion``) against the repository's
``bench.py``, ``bench_extract.py`` and ``tools/bench_diffusion.py``.

* The reconstruction bench's configs, pretrain count and target equal what
  the JAX bench builds: its ``run_config`` runs with the geometry and the
  trainer replaced by recorders, which stop it at its first train step, so
  no JAX step is compiled.  Both quick and full, and each of the seven
  ablation variables at a non-default value.
* ``bench.main`` on the CPU prints one JSON line with the JAX bench's keys
  (less ``hbm_util``) and metric string.
* What ``bench_extract`` times, on the same numpy inputs as the JAX
  functions the JAX bench times: the tets extractor (template, cut,
  tangents, normals) and FlexiCubes at res 8, ``pbr_bsdf`` and the
  gradient of its sum at [1, 16, 16].  Faces and masks exactly; values to
  1e-5 relative; the smooth normals and the tangents, which amplify the
  float32 round-off of their sums, to the limits below (readings: normals
  1.0e-5 tets and 3.5e-6 FlexiCubes, tangents 2.8e-6).  FlexiCubes rows
  are held where a valid face reads them (unread boundary slots
  extrapolate ν, as in JAX); tangents off the branch cut of the
  orthonormal basis, where a normal's z is within round-off of 0 and its
  sign, which picks the branch, is round-off.
* ``bench_diffusion`` on a tiny U-Net: its line, and its model TFLOP/s.
"""
import dataclasses
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gshell_tpu.geometry.geometry as jgeometry
import gshell_tpu.train.reconstruct as jreconstruct
from gshell_tpu.geometry.cube_grid import build_cube_grid as j_build_cube_grid
from gshell_tpu.geometry.gshell_flexicubes import GShellFlexiCubes as JGShellFlexiCubes
from gshell_tpu.geometry.gshell_tets import GShellTets as JGShellTets
from gshell_tpu.geometry.tet_grid import build_tet_grid as j_build_tet_grid
from gshell_tpu.ops.bsdf import pbr_bsdf as j_pbr_bsdf
from gshell_tpu.ops.mesh_ops import auto_normals as j_auto_normals
from gshell_tpu_torch import bench, bench_diffusion, bench_extract
from gshell_tpu_torch.models.unet3d import forward_flops
from torch_parity import assert_close, n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ABLATIONS = {"GSHELL_VIEW_MODE": "map_remat", "GSHELL_CAP_SAFETY": "0.5", "GSHELL_SHADE_BUDGET": "0",
             "GSHELL_BSDF": "diffuse", "GSHELL_NO_DENOISER": "1", "GSHELL_JITTER_TAP": "0.5",
             "GSHELL_MC_BLOCK": "4"}
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "compile_sec", "achieved_tflops", "mfu"}  # less hbm_util
NRM_ATOL = 1e-4
TNG_ATOL = 3e-5
BRANCH_CUT_NZ = 1e-4  # |n_z| within this of 0: the basis's branch is round-off


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _jax_bench_record(monkeypatch, quick, cfg):
    """What the JAX bench's ``run_config`` builds, up to its first step."""
    seen = {}

    class Geometry:
        def __init__(self, gcfg):
            seen["gcfg"] = gcfg

    class Trainer:
        def __init__(self, geo, mat_cfg, flags, tcfg):
            seen.update(mat_cfg=mat_cfg, flags=flags, tcfg=tcfg)

        def init_state(self, key, pretrain_steps):
            seen["pretrain"] = pretrain_steps

        def train_step(self, state, key, target):
            seen["target"] = target
            raise _Stop

    monkeypatch.setattr(jgeometry, "GShellGeometry", Geometry)
    monkeypatch.setattr(jreconstruct, "Reconstructor", Trainer)
    with pytest.raises(_Stop):
        _load("jax_bench", "bench.py").run_config(quick, *cfg)
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


@pytest.mark.parametrize("var", [None] + sorted(ABLATIONS))
@pytest.mark.parametrize("quick", [False, True])
def test_bench_configs_and_target_equal_jax(monkeypatch, quick, var):
    for k in ABLATIONS:
        monkeypatch.delenv(k, raising=False)
    if var is not None:
        monkeypatch.setenv(var, ABLATIONS[var])
    cfg = bench.QUICK_POINT if quick else bench.WORKING_POINT
    want = _jax_bench_record(monkeypatch, quick, cfg)
    gcfg, mat_cfg, flags, tcfg, pretrain = bench.bench_configs(quick, *cfg)
    shared = _assert_shared_equal(gcfg, want["gcfg"], "GeometryConfig")
    assert {"view_batch_mode", "capacity_safety", "n_eikonal_samples", "grid_res"} <= set(shared)
    _assert_shared_equal(mat_cfg, want["mat_cfg"], "MLPTexture3DConfig")
    shared = _assert_shared_equal(flags, want["flags"], "RenderFlags")
    assert {"bsdf", "use_denoiser", "shade_budget", "jitter_tap_frac", "mc_block", "resolution"} <= set(shared)
    _assert_shared_equal(tcfg, want["tcfg"], "TrainConfig")
    assert pretrain == want["pretrain"]
    res, _, _, batch = cfg
    target = bench.make_target(res, batch, CPU)
    assert set(target) == set(want["target"])
    for k, v in want["target"].items():
        np.testing.assert_array_equal(n(target[k]), np.asarray(v), err_msg=k)


def test_bench_prints_one_line_with_jax_keys(capsys):
    rec = bench.main(["--quick", "--one", "64,16,2,1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert JAX_KEYS <= set(line) and "hbm_util" not in line
    assert line["metric"] == "gshell_train_step_iters_per_sec(res64,grid16,spp2,b1)"
    assert line["unit"] == "iters/sec" and line["device"] == "cpu"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == line["value"] / 2.5
    assert line["achieved_tflops"] > 0 and line["mfu"] is None  # no device peak on the CPU
    assert math.isfinite(rec["loss"]) and rec["n_valid_tets"] > 0
    assert len(rec["step_launches"]) == 5


@pytest.mark.parametrize("mod", [bench, bench_extract, bench_diffusion])
def test_entry_points_refuse_without_a_card(monkeypatch, mod):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code not in (0, None)


def test_tets_extraction_equals_jax():
    fn, args = bench_extract.tets_case(8, CPU)
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
    fn, args = bench_extract.flexicubes_case(8, CPU)
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
    args = bench_extract.bsdf_inputs((1, 16, 16), CPU)
    j_args = tuple(jnp.asarray(n(a)) for a in args)
    assert_close(bench_extract.bsdf_forward(*args), j_pbr_bsdf(*j_args), rtol=1e-5, atol=1e-6, what="pbr_bsdf")
    want = jax.grad(lambda *a: j_pbr_bsdf(*a).sum(), argnums=(0, 1))(*j_args)
    for name, got, w in zip(("d/dkd", "d/darm"), bench_extract.bsdf_backward(*args), want):
        assert_close(got, w, rtol=1e-5, atol=1e-6, what=name)
    assert n(args[3]).shape == (1, 16, 16, 3)
    np.testing.assert_allclose(np.linalg.norm(n(args[3]), axis=-1), 1.0, rtol=1e-6)


def test_bench_diffusion_line_on_a_tiny_unet(capsys):
    cfg = dataclasses.replace(bench_diffusion.UNET, base_channels=8, ch_mult=(1, 2),
                              down_block_types=("ResBlock", "AttnResBlock"),
                              up_block_types=("AttnResBlock", "ResBlock"), num_res_blocks=1,
                              num_res_blocks_1st_layer=1)
    out = bench_diffusion.run(8, 1, 1, CPU, cfg)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["metric"] == "gmeshdiffusion_train_step(grid8,occ16,b1)" and out["unit"] == "ms/step"
    assert {"value", "iters_per_sec", "params_M", "compile_sec", "recipe_2p4M_days_h100x8", "achieved_tflops",
            "mfu"} <= set(out) and "hbm_util" not in out
    assert out["value"] > 0 and math.isclose(out["iters_per_sec"], 1000.0 / out["value"], rel_tol=1e-12)
    want = forward_flops(cfg, 8) * 3 * 1 / (out["value"] / 1000.0) / 1e12
    assert math.isclose(out["achieved_tflops"], want, rel_tol=1e-12)
    assert out["mfu"] is None and out["recipe_2p4M_days_h100x8"] is None  # card numbers, none on the CPU
    assert out["params_M"] > 0 and math.isfinite(out["compile_sec"])
