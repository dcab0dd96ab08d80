"""The port's generative codec and the diffusion command lines
(``gshell_tpu_torch/geometry/generative_decode.py``, ``bake_grids``,
``main_diffusion``, ``eval_gmeshdiffusion``) against the JAX package, at tet
resolution 8.

* The lattice edge numbering (``edges_pad``, ``edge_ids_from``) equals the
  JAX extractor's.
* ``fields`` of every direct / MLP combination of SDF and mSDF to 1e-6.
* ``bake``: signs, masks and the occupancy mask exactly, coefficients and
  deform to 1e-6.  The port scatters only valid cut slots; JAX also writes
  its invalid slots, clipped onto a site, with value 0 and mask 0 — a site
  no valid slot uses, so the grids agree (ROADMAP C).
* ``decode`` of the same grids: faces and validity exactly, vertices to
  1e-6; and the round trip ``decode(bake(·))`` against the port's
  extractor (equal faces, vertices within 2e-2, as
  ``tests/test_generative_decode.py`` holds JAX's).
* ``laplacian_smooth`` exactly.
* The command lines on the CPU: bake → train 2 → resume → the four modes →
  OBJs, and the JAX evaluator decodes the port's ``.npz`` files to the
  port's meshes.
"""
import functools
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.geometry import geometry as jgeometry
from gshell_tpu.geometry.generative_decode import GenerativeCodec as JCodec
from gshell_tpu.geometry.gshell_tets import GShellTets as JTets
from gshell_tpu.geometry.mlp import MLPConfig as JMLPConfig
from gshell_tpu.geometry.tet_grid import build_tet_grid as jbuild
from gshell_tpu_torch import bake_grids, eval_gmeshdiffusion, main_diffusion
from gshell_tpu_torch.convert import params_geo_from_jax
from gshell_tpu_torch.geometry.generative_decode import BakedGrids, GenerativeCodec
from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.geometry.gshell_tets import GShellTets
from gshell_tpu_torch.geometry.mlp import MLPConfig
from gshell_tpu_torch.geometry.tet_grid import build_tet_grid
from gshell_tpu_torch.utils.synthetic import open_ellipsoid_state
from torch_parity import assert_close, n

torch.set_num_threads(1)
RES = 8
SMALL_MLP = dict(n_freq=2, d_hidden=16, n_hidden=2, skip_in=(1,))


@pytest.fixture(scope="module")
def codecs():
    jex = JTets(jbuild(RES))
    jex.edges_pad  # cached on first use: outside jit, so no trace keeps a tracer of it
    tex = GShellTets(build_tet_grid(RES, build_topology=False), "cpu")
    return JCodec(jex), GenerativeCodec(tex)


@pytest.mark.parametrize("res", [3, RES])
def test_edge_numbering_equals_jax(res):
    jex, tex = JTets(jbuild(res)), GShellTets(build_tet_grid(res, build_topology=False), "cpu")
    np.testing.assert_array_equal(n(tex.edges_pad), np.asarray(jex.edges_pad))
    assert tex.n_grid_edges == jex.n_grid_edges
    rng = np.random.default_rng(res)
    lo = rng.integers(0, res, size=(50, 3))
    cls = rng.integers(0, 7, size=(50,))
    np.testing.assert_array_equal(n(tex.edge_ids_from(torch.from_numpy(lo), torch.from_numpy(cls))),
                                  np.asarray(jex.edge_ids_from(jnp.asarray(lo, jnp.int32), jnp.asarray(cls))))


@pytest.mark.parametrize("sdf_mlp,msdf_mlp", [(False, False), (True, False), (False, True), (True, True)])
def test_fields_match_jax(sdf_mlp, msdf_mlp):
    """Every combination of a direct or an MLP field, the JAX state carried
    by ``convert.params_geo_from_jax``; the field type is read from the
    state's keys, as ``bake_grids`` does."""
    jgeo = jgeometry.GShellGeometry(jgeometry.GeometryConfig(
        grid_res=RES, use_sdf_mlp=sdf_mlp, use_msdf_mlp=msdf_mlp, mlp=JMLPConfig(**SMALL_MLP)))
    params = jgeo.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params["deform"] = jnp.asarray(rng.uniform(-0.3, 0.3, size=params["deform"].shape).astype(np.float32))
    want = jgeo.fields(params)
    tp = params_geo_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    assert ("sdf_net" in tp) == sdf_mlp and ("msdf_net" in tp) == msdf_mlp
    geo = GShellGeometry(GeometryConfig(grid_res=RES, use_sdf_mlp="sdf_net" in tp, use_msdf_mlp="msdf_net" in tp,
                                        mlp=MLPConfig(**SMALL_MLP)), "cpu")
    for got, w, what in zip(geo.fields(tp), want, ("v_def", "sdf", "msdf")):
        assert_close(got, w, rtol=1e-6, atol=1e-6, what=what)


def test_flexi_direct_sdf_state_converts():
    """``convert.params_geo_from_jax`` on a FlexiCubes state with a direct
    SDF: per-cube weights, the direct ``sdf`` and ``msdf``; the port's
    FlexiCubes ``fields`` of it equal JAX's."""
    from gshell_tpu.geometry.flexi_geometry import FlexiGeometryConfig as JFlexiConfig
    from gshell_tpu.geometry.flexi_geometry import GShellFlexiGeometry as JFlexi
    from gshell_tpu_torch.geometry.flexi_geometry import FlexiGeometryConfig, GShellFlexiGeometry

    jgeo = JFlexi(JFlexiConfig(grid_res=6, use_sdf_mlp=False))
    params = jgeo.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    params["deform"] = jnp.asarray(rng.uniform(-0.3, 0.3, size=params["deform"].shape).astype(np.float32))
    params["cube_weights"] = jnp.asarray(rng.normal(size=params["cube_weights"].shape).astype(np.float32))
    tp = params_geo_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    assert sorted(tp) == sorted(params) == ["cube_weights", "deform", "msdf", "sdf"]
    np.testing.assert_array_equal(n(tp["cube_weights"]), np.asarray(params["cube_weights"]))
    geo = GShellFlexiGeometry(FlexiGeometryConfig(grid_res=6, use_sdf_mlp=False), "cpu")
    for got, w, what in zip(geo.fields(tp), jgeo.fields(params), ("v_def", "sdf", "msdf")):
        assert_close(got, w, rtol=1e-6, atol=1e-6, what=what)


def test_direct_sdf_init_matches_jax():
    jgeo = jgeometry.GShellGeometry(jgeometry.GeometryConfig(grid_res=RES, use_sdf_mlp=False))
    geo = GShellGeometry(GeometryConfig(grid_res=RES, use_sdf_mlp=False), "cpu")
    from gshell_tpu_torch.utils.rng import TorchDraws

    got = geo.init_params(TorchDraws(torch.Generator().manual_seed(0)))
    want = jgeo.init_params(jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want) == ["deform", "msdf", "sdf"]
    assert_close(got["sdf"], want["sdf"], rtol=1e-6, atol=1e-7, what="sdf")
    assert (n(got["deform"]) == 0).all()


def _shape_fields(seed: int):
    """(pos, sdf, msdf, deform) numpy of an open ellipsoid at RES, through
    the port's ``fields``."""
    st = open_ellipsoid_state(RES, seed)["params_geo"]
    geo = GShellGeometry(GeometryConfig(grid_res=RES, use_sdf_mlp=False), "cpu")
    v_def, sdf, msdf = geo.fields(st)
    return n(v_def), n(sdf), n(msdf), n(st["deform"])


@pytest.fixture(scope="module", params=[0, 1, 2])
def baked(request, codecs):
    jc, tc = codecs
    pos, sdf, msdf, deform = _shape_fields(request.param)
    want = jax.jit(jc.bake)(jnp.asarray(pos), jnp.asarray(sdf), jnp.asarray(msdf), jnp.asarray(deform))
    got = tc.bake(*(torch.from_numpy(a) for a in (pos, sdf, msdf, deform)))
    return dict(pos=pos, sdf=sdf, msdf=msdf, want=want, got=got)


def test_bake_signs_and_masks_equal_jax(baked):
    w, g = baked["want"], baked["got"]
    for field in BakedGrids._fields:
        assert tuple(getattr(g, field).shape) == tuple(getattr(w, field).shape), field
    np.testing.assert_array_equal(n(g.feature_mask), np.asarray(w.feature_mask))
    np.testing.assert_array_equal(n(g.occ_mask), np.asarray(w.occ_mask))
    fm = np.asarray(w.feature_mask)
    # channel 0 at vertex sites and channel 1 at edge sites are signs
    np.testing.assert_array_equal(np.sign(n(g.grid)[..., :2]) * fm[..., :2],
                                  np.sign(np.asarray(w.grid)[..., :2]) * fm[..., :2])
    assert int(fm[..., 0].sum()) > 0 and int(np.asarray(w.occ_mask).sum()) > 0


def test_bake_coefficients_match_jax(baked):
    w, g = baked["want"], baked["got"]
    assert_close(g.grid, w.grid, rtol=1e-6, atol=1e-6, what="grid")
    assert_close(g.occgrid, w.occgrid, rtol=1e-6, atol=1e-6, what="occgrid")


def test_decode_matches_jax(baked, codecs):
    """Decode JAX's grids on both sides."""
    jc, tc = codecs
    w = baked["want"]
    mj = jax.jit(jc.decode)(jnp.asarray(baked["pos"]), w)
    mt = tc.decode(torch.from_numpy(baked["pos"]), BakedGrids(*(torch.from_numpy(np.array(a)) for a in w)))
    np.testing.assert_array_equal(n(mt.face_valid), np.asarray(mj.face_valid))
    np.testing.assert_array_equal(n(mt.faces), np.asarray(mj.faces))
    assert int(mt.n_valid_tets) == int(mj.n_valid_tets) and int(mt.n_crossing_edges) == int(mj.n_crossing_edges)
    assert int(n(mt.face_valid).sum()) > 0
    assert_close(mt.verts, mj.verts, rtol=1e-6, atol=1e-6, what="verts")


def test_roundtrip_equals_the_extractor(baked, codecs):
    _, tc = codecs
    pos, sdf, msdf = (torch.from_numpy(baked[k]) for k in ("pos", "sdf", "msdf"))
    direct = tc.ex(pos, sdf, msdf)
    dec = tc.decode(pos, baked["got"])
    fv = direct.face_valid
    assert torch.equal(fv, dec.face_valid) and int(fv.sum()) > 0
    assert torch.equal(direct.faces[fv], dec.faces[fv])
    used = torch.unique(direct.faces[fv])
    assert float((direct.verts[used] - dec.verts[used]).abs().max()) < 2e-2


def test_laplacian_smooth_equals_the_jax_package():
    import eval_gmeshdiffusion as jeval

    rng = np.random.default_rng(0)
    v = rng.normal(size=(40, 3))
    f = rng.integers(0, 40, size=(70, 3))
    for iters in (0, 1, 3):
        np.testing.assert_array_equal(eval_gmeshdiffusion.laplacian_smooth(v, f, iters),
                                      jeval.laplacian_smooth(v, f, iters))


# ---------------------------------------------------------------- the command lines


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """bake 2 shapes → train 2 iterations (snapshot at 1) → resume to 4 →
    each sampling mode → decode, all through the port's ``main()`` on the CPU."""
    root = tmp_path_factory.mktemp("pipeline")
    for i in range(2):
        os.makedirs(root / "states" / f"shape{i}")
        torch.save(open_ellipsoid_state(RES, seed=i), root / "states" / f"shape{i}" / "state.pt")
    out = {"baked": bake_grids.main(["--states", str(root / "states" / "*" / "state.pt"), "--grid-res", str(RES),
                                     "--out-dir", str(root / "baked"), "--device", "cpu"])}
    fm = om = None
    for path in out["baked"].values():
        with np.load(path) as z:
            fm = z["feature_mask"] if fm is None else np.maximum(fm, z["feature_mask"])
            om = z["occ_mask"] if om is None else np.maximum(om, z["occ_mask"])
    np.savez(root / "masks.npz", feature_mask=fm, occ_mask=om)
    wd = str(root / "run")
    common = ["--workdir", wd, "--grid-size", str(2 * RES), "--base-channels", "8", "--ch-mult", "1,2",
              "--mask-file", str(root / "masks.npz"), "--device", "cpu"]
    train = ["--mode", "train", "--data-glob", str(root / "baked" / "*.npz"), "--batch", "1", "--grad-acc", "2",
             "--snapshot-freq", "1", "--log-freq", "1"] + common
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out["first"] = main_diffusion.main(train + ["--n-iters", "2"])
        out["resumed"] = main_diffusion.main(train + ["--n-iters", "4"])
        out["straight"] = main_diffusion.main([a if a != wd else wd + "_straight" for a in train] + ["--n-iters", "4"])
    finally:
        torch.use_deterministic_algorithms(was)
    ddim = ["--sampling-method", "ddim", "--n-sampling-steps", "2", "--n-samples", "1"]
    out["uncond"] = main_diffusion.main(["--mode", "uncond_gen"] + ddim + common)
    out["interp"] = main_diffusion.main(["--mode", "uncond_gen_interp"] + ddim + common)
    with np.load(out["baked"]["shape0"]) as z:
        cmask = np.zeros(z["grid"].shape, np.float32)
        cmask[: RES] = 1.0
        np.savez(root / "cond.npz", grid=z["grid"], cond_mask=cmask)
    with pytest.MonkeyPatch.context() as mp:  # cond_gen walks all N ancestral steps: N 50 here, not 1000
        mp.setattr(main_diffusion, "DiffusionTrainConfig",
                   functools.partial(main_diffusion.DiffusionTrainConfig, num_scales=50))
        out["cond"] = main_diffusion.main(["--mode", "cond_gen", "--cond-file", str(root / "cond.npz"),
                                           "--n-samples", "1"] + common)
    with np.load(out["baked"]["shape0"]) as z:
        np.savez(os.path.join(wd, "baked_shape0.npz"), grid=z["grid"], occgrid=z["occgrid"])
    out["faces"] = eval_gmeshdiffusion.main(["--samples", os.path.join(wd, "*.npz"), "--grid-res", str(RES),
                                             "--out-dir", str(root / "meshes"), "--device", "cpu"])
    out.update(root=root, wd=wd)
    return out


def test_pipeline_bakes_reference_shaped_grids(pipeline):
    assert sorted(pipeline["baked"]) == ["shape0", "shape1"]
    for path in pipeline["baked"].values():
        with np.load(path) as z:
            assert z["grid"].shape == (2 * RES,) * 3 + (4,) and z["occgrid"].shape == (4 * RES,) * 3
            assert z["feature_mask"].shape == z["grid"].shape and z["occ_mask"].shape == z["occgrid"].shape


def test_pipeline_resume_goes_on_from_the_saved_step(pipeline):
    first, resumed = pipeline["first"], pipeline["resumed"]
    assert [e["step"] for e in first["log"]] == [0, 1]
    assert resumed["start_step"] == 2 and [e["step"] for e in resumed["log"]] == [2, 3]
    assert os.path.getsize(os.path.join(pipeline["wd"], "checkpoints-meta.pt")) == first["snapshot_bytes"]
    assert all(np.isfinite(e["loss"]) for e in first["log"] + resumed["log"])


def test_pipeline_resumed_run_equals_a_straight_run(pipeline):
    """2 + 2 iterations through the command line equal 4 straight ones, bit
    for bit (the file stream and each step's draws are seeded by the step)."""
    a = torch.load(os.path.join(pipeline["wd"], "checkpoints-meta.pt"), weights_only=True)
    b = torch.load(os.path.join(pipeline["wd"] + "_straight", "checkpoints-meta.pt"), weights_only=True)
    assert a["step"] == b["step"] == 4
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert all(torch.equal(x, y) for x, y in zip(a["ema"]["params"], b["ema"]["params"]))
    assert [e["loss"] for e in pipeline["resumed"]["log"]] == [e["loss"] for e in pipeline["straight"]["log"][2:]]


def test_pipeline_writes_every_mode_in_the_jax_layout(pipeline):
    wd = pipeline["wd"]
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(wd, "*.npz")))
    assert names == ["baked_shape0.npz", "cond_sample_0000.npz"] + [f"interp_0000_{j:02d}.npz" for j in range(8)] \
        + ["sample_0000.npz"]
    for name in names:
        with np.load(os.path.join(wd, name)) as z:
            assert z["grid"].shape == (2 * RES,) * 3 + (4,) and z["occgrid"].shape == (4 * RES,) * 3
            assert np.isfinite(z["grid"]).all() and np.isfinite(z["occgrid"]).all()
    assert pipeline["uncond"]["start_step"] == 4
    with np.load(os.path.join(wd, "cond_sample_0000.npz")) as z, np.load(pipeline["baked"]["shape0"]) as b:
        # the known half of the condition comes back near the condition (re-noised to level 0)
        known = b["feature_mask"][: RES] > 0
        assert np.abs(z["grid"][: RES][known] - b["grid"][: RES][known]).max() < 0.2


def test_pipeline_decodes_the_baked_grid_to_the_roundtrip_mesh(pipeline):
    faces = pipeline["faces"]
    assert sorted(faces) == sorted(os.path.splitext(os.path.basename(p))[0]
                                   for p in glob.glob(os.path.join(pipeline["wd"], "*.npz")))
    pos, sdf, msdf, deform = _shape_fields(0)
    ex = GShellTets(build_tet_grid(RES, build_topology=False), "cpu")
    direct = ex(*(torch.from_numpy(a) for a in (pos, sdf, msdf)))
    assert faces["baked_shape0"] == int(direct.face_valid.sum()) > 0
    assert os.path.exists(pipeline["root"] / "meshes" / "sample_0000.obj")


def test_jax_evaluator_decodes_the_ports_files_to_the_ports_meshes(pipeline, tmp_path, monkeypatch):
    """The port's samples and grids are the JAX package's ``.npz`` layout:
    JAX's ``eval_gmeshdiffusion`` writes the same meshes from them."""
    import eval_gmeshdiffusion as jeval

    from gshell_tpu_torch.render.mesh import load_obj

    wd = pipeline["wd"]
    monkeypatch.setattr(sys, "argv", ["eval_gmeshdiffusion.py", "--samples", os.path.join(wd, "baked_shape0.npz"),
                                      "--grid-res", str(RES), "--out-dir", str(tmp_path)])
    jeval.main()
    mj = load_obj(str(tmp_path / "baked_shape0.obj"))
    mt = load_obj(str(pipeline["root"] / "meshes" / "baked_shape0.obj"))
    assert len(mj.t_pos_idx) == len(mt.t_pos_idx) == pipeline["faces"]["baked_shape0"]
    np.testing.assert_array_equal(n(mt.t_pos_idx), n(mj.t_pos_idx))
    np.testing.assert_allclose(n(mt.v_pos), n(mj.v_pos), atol=2e-6)
