"""The port's command-line path with FlexiCubes on the CPU, at a tiny
configuration (voxel grid 12, 64², n_samples 2, batch 1, a small SDF MLP
pretrained on the lattice, 4 ground-truth views of a small sphere, shadowed
ground truth and training): ``train_gshell --flexicubes`` writes the OBJ,
the state (with the per-cube weights and their Adam moments) and
``probe.hdr``; two iterations, then ``--resume`` for two more, equal four
straight bit for bit under PyTorch's deterministic algorithms;
``use_flexicubes`` in the config selects the same path; and
``eval_reconstruction`` measures a FlexiCubes state (held-out PSNR,
Chamfer), whatever the config says of the geometry."""
import json
import math

import pytest
import torch

from gshell_tpu_torch import eval_reconstruction, train_gshell
from gshell_tpu_torch.utils.synthetic_gt import sphere, write_obj

TINY = {"iter": 4, "save_interval": 2, "train_res": [64, 64], "batch": 1, "learning_rate": [0.03, 0.005],
        "background": "white", "denoiser": "bilateral", "n_samples": 2, "voxel_grid": 12, "gshell_grid": 16,
        "mesh_scale": 1.4, "use_sdf_mlp": True, "shade_budget": 0.5, "gt_shadows": True, "n_freq": 4,
        "d_hidden": 32, "n_hidden": 2, "skip_in": [1], "sdf_mlp_pretrain_steps": 200,
        "boxscale": [1, 1, 1], "aabb": [-1, -1, -1, 1, 1, 1]}


def _tree_leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tree_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tree_leaves(v)]
    return []


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("flexi_cli")
    (d / "tiny.json").write_text(json.dumps(TINY))
    (d / "tiny_flexi.json").write_text(json.dumps({**TINY, "use_flexicubes": True}))
    write_obj(str(d / "sphere.obj"), *sphere(16, 12))
    return d


def _train_argv(files, out, *extra, config="tiny.json"):
    return ["--config", str(files / config), "--ref-mesh", str(files / "sphere.obj"), "--out-dir",
            str(files / out), "--device", "cpu", "--log-interval", "1", *extra]


@pytest.fixture(scope="module")
def runs(files):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    mp = pytest.MonkeyPatch()
    mp.setattr(train_gshell, "GT_VIEWS", 4)  # a module-scoped fixture cannot take ``monkeypatch``
    try:
        straight = train_gshell.main(_train_argv(files, "straight", "--flexicubes"))
        first = train_gshell.main(_train_argv(files, "split", "-i", "2", "--snapshot-images", "no",
                                              config="tiny_flexi.json"))
        resumed = train_gshell.main(_train_argv(files, "split", "--resume", config="tiny_flexi.json"))
    finally:
        mp.undo()
        torch.use_deterministic_algorithms(prev)
    return straight, first, resumed


def test_flexi_cli_writes_mesh_state_and_probe(files, runs):
    straight = runs[0]
    out = files / "straight"
    assert [e["it"] for e in straight["log"]] == [0, 1, 2, 3] and straight["start_it"] == 0
    for e in straight["log"]:
        assert all(math.isfinite(e[k]) for k in ("total", "img_loss", "reg_loss", "l_dev"))
        assert e["n_surf_cubes"] > 0 and e["n_faces"] > 0 and e["raster_dropped"] == 0
        assert e["cube_slot_overflow"] == e["edge_slot_overflow"] == e["face_cap_overflow"] == 0
        assert e["splat_cells"] > 0
    text = (out / "mesh_000004.obj").read_text()
    assert text.count("\nf ") == straight["final_faces"] > 0
    assert (out / "mesh_000002.obj").exists() and (out / "img_000002.png").exists()
    assert (out / "probe.hdr").exists()
    rec = torch.load(str(out / "state.pt"), weights_only=True)
    assert rec["step"] == 4 and tuple(rec["params_geo"]["cube_weights"].shape) == (12**3, 21)
    assert float(rec["params_geo"]["cube_weights"].detach().abs().max()) > 0  # trained from zero
    assert len(rec["optimizers"][0]["param_groups"]) == 4  # deform, cube_weights, msdf, sdf_net


def test_flexi_cli_resume_equals_a_straight_run_bit_for_bit(files, runs):
    """The straight run takes ``--flexicubes``, the split one ``use_flexicubes``
    in its config: the same path."""
    straight, first, resumed = runs
    assert resumed["start_it"] == 2 and [e["it"] for e in resumed["log"]] == [2, 3]
    for a, b in zip(straight["log"], first["log"] + resumed["log"]):
        assert {k: a[k] for k in a if k != "s"} == {k: b[k] for k in b if k != "s"}
    sa = torch.load(str(files / "straight" / "state.pt"), weights_only=True)
    sb = torch.load(str(files / "split" / "state.pt"), weights_only=True)
    for key in ("params_geo", "params_mat", "light_base", "optimizers", "draws"):
        la, lb = _tree_leaves(sa[key]), _tree_leaves(sb[key])
        assert len(la) == len(lb) > 0, key
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), key
    assert sa["schedulers"] == sb["schedulers"] and sa["extra"] == sb["extra"]


def test_flexi_eval_writes_metrics_psnr_and_chamfer(files, runs, monkeypatch):
    monkeypatch.setattr(eval_reconstruction, "CHAMFER_SAMPLES", 2048)
    out = files / "validate"
    res = eval_reconstruction.main([
        "--state", str(files / "straight" / "state.pt"), "--config", str(files / "tiny_flexi.json"),
        "--synthetic-ref-mesh", str(files / "sphere.obj"), "--gt-mesh", str(files / "sphere.obj"),
        "--n-views", "2", "--out-dir", str(out), "--device", "cpu"])
    lines = (out / "metrics.txt").read_text().splitlines()
    assert lines[0] == "ID, MSE, PSNR" and len(lines) == 4
    assert math.isfinite(res["psnr"]) and res["psnr"] > 5.0
    assert math.isfinite(res["chamfer"]) and res["chamfer"] > 0.0
    assert res["launches"]["synthetic"] == {"rasterize_stage_b": 0, "bilateral_accumulate": 0,
                                            "gather_rows": 0}  # the CPU


@pytest.mark.parametrize("config", ["tiny.json", "tiny_flexi.json"])
def test_eval_takes_the_geometry_from_the_state(files, runs, config, capsys):
    """A FlexiCubes state is read as one under a tets config too: its
    per-cube weights choose the geometry, and the mesh is the run's."""
    argv = ["--state", str(files / "straight" / "state.pt"), "--config", str(files / config),
            "--out-dir", str(files / "val_none"), "--device", "cpu"]
    assert eval_reconstruction.main(argv) == {"launches": {}}
    assert f"step 4, {runs[0]['final_faces']} faces" in capsys.readouterr().out


@pytest.mark.parametrize("setting, keys", [({"use_sdf_mlp": False}, ["cube_weights", "deform", "msdf", "sdf"])])
def test_flexi_field_settings_train_resume_and_evaluate(files, tmp_path, monkeypatch, setting, keys):
    """A direct SDF on FlexiCubes: one iteration, one resumed, an eval; the
    snapshot holds the direct field (the sphere it starts as, stepped)."""
    (tmp_path / "cfg.json").write_text(json.dumps({**TINY, "use_flexicubes": True, **setting}))
    monkeypatch.setattr(train_gshell, "GT_VIEWS", 2)
    monkeypatch.setattr(eval_reconstruction, "CHAMFER_SAMPLES", 1024)
    argv = _train_argv(files, "never", "--snapshot-images", "no")
    argv[argv.index("--config") + 1] = str(tmp_path / "cfg.json")
    argv[argv.index("--out-dir") + 1] = str(tmp_path / "run")
    train_gshell.main(argv + ["-i", "1"])
    resumed = train_gshell.main(argv + ["-i", "2", "--resume"])
    assert resumed["start_it"] == 1 and resumed["log"][0]["n_faces"] > 0 and resumed["log"][0]["eik_loss"] == 0
    res = eval_reconstruction.main([
        "--state", str(tmp_path / "run" / "state.pt"), "--config", str(tmp_path / "cfg.json"),
        "--synthetic-ref-mesh", str(files / "sphere.obj"), "--gt-mesh", str(files / "sphere.obj"),
        "--n-views", "1", "--out-dir", str(tmp_path / "val"), "--device", "cpu"])
    assert math.isfinite(res["psnr"]) and math.isfinite(res["chamfer"])
    rec = torch.load(str(tmp_path / "run" / "state.pt"), weights_only=True)
    assert rec["step"] == 2 and sorted(rec["params_geo"]) == keys and rec["params_geo"]["sdf"].shape == (13 ** 3,)
