"""The port's command line with the options of the textured path, on the
CPU at a tiny size (``tests/test_torch_cli.py``'s config: 64², tet grid 16,
4 ground-truth views, 200 SDF pretrain steps): ``train_gshell --bake-texture 64`` writes
``texture_kd.png``, ``texture_ks.png``, ``mesh_textured.obj`` and
``baked.mtl``, for both extractors; ``load_baked`` reads them back and they
render through the Texture2D branch, and the baked kd renders as the neural
kd on the same view (the round trip of ``chip_smoke.py`` phase 11, at 64²);
a config with ``spp`` 2, ``denoiser_demodulate: false`` and ``bsdf`` "kd"
trains; and eval renders at ``spp`` 1 with denoising before modulation
whatever the config says, as JAX's eval builds its flags."""
import json
import math

import numpy as np
import pytest
import torch
from test_torch_cli import TINY

from gshell_tpu_torch import eval_reconstruction, train_gshell
from gshell_tpu_torch.ops.math import lookat, mse_to_psnr, perspective
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.render.render import render_mesh
from gshell_tpu_torch.render.texture import create_trainable
from gshell_tpu_torch.train.reconstruct import load_state
from gshell_tpu_torch.train.setup import reconstructor_from_flags
from gshell_tpu_torch.utils.config import load_flags
from gshell_tpu_torch.utils.image import load_png
from gshell_tpu_torch.utils.rng import TorchDraws
from gshell_tpu_torch.utils.synthetic import vary_material
from gshell_tpu_torch.utils.synthetic_gt import sphere, write_obj

BAKE_RES = 64
BAKED_FILES = ("texture_kd.png", "texture_ks.png", "mesh_textured.obj", "baked.mtl")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bake_cli")
    # a sphere pretrained long enough that both extractors cut a surface
    bake = {**TINY, "iter": 2, "save_interval": 0, "sdf_mlp_pretrain_steps": 200}
    (d / "tiny.json").write_text(json.dumps(bake))
    (d / "tiny_flexi.json").write_text(json.dumps({**bake, "iter": 1, "use_flexicubes": True, "voxel_grid": 12}))
    (d / "options.json").write_text(json.dumps({**TINY, "iter": 1, "save_interval": 0, "spp": 2,
                                                "denoiser_demodulate": False, "bsdf": "kd"}))
    write_obj(str(d / "sphere.obj"), *sphere(16, 12))
    return d


def _argv(files, cfg, out, *extra):
    return ["--config", str(files / cfg), "--ref-mesh", str(files / "sphere.obj"), "--out-dir", str(files / out),
            "--device", "cpu", "--log-interval", "1", *extra]


@pytest.fixture(scope="module")
def baked(files):
    """Each extractor trains its iterations, its state's material gets a kd
    that varies (``vary_material``), and a resumed call with nothing left
    to train bakes it: the flow of ``chip_smoke.py`` phase 11."""
    mp = pytest.MonkeyPatch()
    mp.setattr(train_gshell, "GT_VIEWS", 4)
    out = {}
    try:
        for cfg in ("tiny.json", "tiny_flexi.json"):
            name = cfg.split(".")[0]
            train_gshell.main(_argv(files, cfg, name))
            state_path = str(files / name / "state.pt")
            record = torch.load(state_path, weights_only=True)
            record["params_mat"] = vary_material(record["params_mat"], seed=0)
            torch.save(record, state_path)
            out[cfg] = train_gshell.main(_argv(files, cfg, name, "--resume", "--bake-texture", str(BAKE_RES)))
            assert out[cfg]["log"] == []
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("cfg", ["tiny.json", "tiny_flexi.json"], ids=["tets", "flexicubes"])
def test_bake_writes_the_four_files(files, baked, cfg):
    out = files / cfg.split(".")[0]
    bake = baked[cfg]["bake"]
    assert all((out / name).exists() for name in BAKED_FILES)
    assert bake["finite"] and 0.05 < bake["covered"] < 1.0 and bake["charts"] >= 1
    assert load_png(str(out / "texture_kd.png")).shape == (BAKE_RES, BAKE_RES, 3)
    text = (out / "mesh_textured.obj").read_text().splitlines()
    assert text[:2] == ["mtllib baked.mtl", "usemtl baked"]
    assert sum(line.startswith("vt ") for line in text) == bake["uv_verts"]
    faces = [line for line in text if line.startswith("f ")]
    assert len(faces) == bake["faces"] > 0 and all("/" in f for f in faces)
    assert (out / "baked.mtl").read_text() == ("newmtl baked\nbsdf pbr\nmap_Kd texture_kd.png\n"
                                               "map_Ks texture_ks.png\n")


def _round_trip(files, cfg, flip_v=False):
    """The baked asset and the trained neural material rendered on one view
    under the kd BSDF → (PSNR of the baked kd against the neural kd on the
    pixels both cover fully, the two renders)."""
    out = files / cfg.split(".")[0]
    flags = load_flags(str(files / cfg))
    rec = reconstructor_from_flags(flags, "cpu")
    state, _ = load_state(rec, str(out / "state.pt"))
    mesh, uvs, tfaces, material = train_gshell.load_baked(str(out))
    if flip_v:  # the control: the atlas upside down
        material = material._replace(kd=create_trainable(material.kd.base.flip(0)))
    res = flags.train_res[0]
    eye = torch.tensor([0.0, 0.4, 2.6])
    mvp = perspective(np.deg2rad(45.0)) @ lookat(eye, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))
    light = update_pdf(state.light_base.detach())
    kd_flags = rec.flags._replace(bsdf="kd", shade_budget=None)
    with torch.no_grad():
        baked = render_mesh(TorchDraws(torch.Generator().manual_seed(0)), mesh.v_pos, mesh.t_pos_idx, mesh.v_nrm,
                            None, material, None, mvp, eye, light, kd_flags, v_tex=uvs, t_tex_idx=tfaces)
        neural_mesh = rec.geo.get_mesh(state.params_geo)
        neural = render_mesh(TorchDraws(torch.Generator().manual_seed(0)), neural_mesh.verts, neural_mesh.faces,
                             neural_mesh.v_nrm, None, state.params_mat, rec.mat_cfg, mvp, eye, light, kd_flags)
    both = (baked["mask"][..., 0] == 1) & (neural["mask"][..., 0] == 1)
    assert int(both.sum()) > 0.1 * res * res
    mse = torch.mean((baked["kd"][..., :3] - neural["kd"][..., :3])[both] ** 2)
    return float(mse_to_psnr(mse)), baked, neural


@pytest.mark.parametrize("cfg", ["tiny.json", "tiny_flexi.json"], ids=["tets", "flexicubes"])
def test_baked_asset_loads_back_and_renders_as_the_neural_material(files, baked, cfg):
    psnr, render, _ = _round_trip(files, cfg)
    assert all(torch.isfinite(v).all() for v in render.values() if isinstance(v, torch.Tensor))
    assert "diffuse_light" not in render
    assert psnr >= 30.0, psnr  # 8-bit atlas, 64² bake of a 64² view


def test_v_flipped_atlas_scores_lower(files, baked):
    """The round trip's control: the atlas upside down loses PSNR, so the
    orientation, not a near-constant material, is what passes."""
    psnr, _, _ = _round_trip(files, "tiny.json")
    flipped, _, _ = _round_trip(files, "tiny.json", flip_v=True)
    assert flipped < psnr - 3.0, (psnr, flipped)


def test_render_options_train(files, monkeypatch):
    """spp 2, denoising after modulation and the kd BSDF: one step, finite
    losses, no light buffers, so no shading regularizer."""
    monkeypatch.setattr(train_gshell, "GT_VIEWS", 2)
    out = train_gshell.main(_argv(files, "options.json", "options"))
    (e,) = out["log"]
    assert all(math.isfinite(e[k]) for k in ("total", "img_loss", "reg_loss")) and e["n_faces"] > 0


def test_eval_ignores_spp_and_denoiser_demodulate(files, baked, monkeypatch):
    """JAX's eval builds its RenderFlags without spp and
    denoiser_demodulate: the same state scores the same under a config
    that sets them."""
    monkeypatch.setattr(eval_reconstruction, "CHAMFER_SAMPLES", 1024)
    cfg = files / "eval_options.json"
    cfg.write_text(json.dumps({**TINY, "spp": 2, "denoiser_demodulate": False}))
    runs = [eval_reconstruction.main(["--state", str(files / "tiny" / "state.pt"), "--config", str(c),
                                      "--synthetic-ref-mesh", str(files / "sphere.obj"), "--n-views", "2",
                                      "--out-dir", str(files / f"eval_{i}"), "--device", "cpu"])
            for i, c in enumerate((files / "tiny.json", cfg))]
    assert math.isfinite(runs[0]["psnr"]) and runs[0]["per_view"] == runs[1]["per_view"]
