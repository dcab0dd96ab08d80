"""The port's command-line path with the second layer and depth supervision
on the CPU: a config with ``layers: 2``, ``use_depth``,
``use_img_2nd_layer``, ``use_depth_2nd_layer`` and ``max_pairs`` (tet grid
12, 64², n_samples 2, batch 2 under ``map_remat``, 4 shadowed ground-truth
views of a small skirt, whose inside the second layer sees) trains: the
ground truth carries both layers and the inverse depths, every step logs a
finite, non-zero ``depth_loss``; two iterations, then ``--resume`` for two
more, equal four straight bit for bit (PyTorch's deterministic algorithms
on).  The same config trains FlexiCubes (voxel 10), and a pair buffer too
small for the mesh drops pairs and counts them in ``raster_dropped``."""
import json
import math

import pytest
import torch

from gshell_tpu_torch import train_gshell
from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj

CFG = {"iter": 4, "save_interval": 2, "train_res": [64, 64], "batch": 2, "learning_rate": [0.03, 0.005],
       "background": "white", "denoiser": "bilateral", "n_samples": 2, "gshell_grid": 12, "voxel_grid": 10,
       "mesh_scale": 1.4, "use_sdf_mlp": True, "shade_budget": 0.5, "gt_shadows": True, "n_freq": 4,
       "d_hidden": 32, "n_hidden": 2, "skip_in": [1], "sdf_mlp_pretrain_steps": 100, "boxscale": [1, 1, 1],
       "aabb": [-1, -1, -1, 1, 1, 1], "layers": 2, "use_depth": True, "use_img_2nd_layer": True,
       "use_depth_2nd_layer": True, "max_pairs": 20000}


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
    d = tmp_path_factory.mktemp("second_layer_cli")
    (d / "two_layers.json").write_text(json.dumps(CFG))
    (d / "two_layers_few_pairs.json").write_text(json.dumps({**CFG, "max_pairs": 256}))
    write_obj(str(d / "skirt.obj"), *skirt(24, 12))
    return d


def _argv(files, out, *extra, config="two_layers.json"):
    return ["--config", str(files / config), "--ref-mesh", str(files / "skirt.obj"), "--out-dir",
            str(files / out), "--device", "cpu", "--log-interval", "1", "--snapshot-images", "no", *extra]


@pytest.fixture(scope="module")
def runs(files):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    mp = pytest.MonkeyPatch()
    mp.setattr(train_gshell, "GT_VIEWS", 4)  # a module-scoped fixture cannot take ``monkeypatch``
    try:
        straight = train_gshell.main(_argv(files, "straight"))
        first = train_gshell.main(_argv(files, "split", "-i", "2"))
        resumed = train_gshell.main(_argv(files, "split", "--resume"))
        flexi = train_gshell.main(_argv(files, "flexi", "-i", "2", "--flexicubes",
                                        config="two_layers_few_pairs.json"))
    finally:
        mp.undo()
        torch.use_deterministic_algorithms(prev)
    return straight, first, resumed, flexi


def test_cli_trains_with_second_layer_and_depth(runs):
    straight = runs[0]
    assert [e["it"] for e in straight["log"]] == [0, 1, 2, 3] and straight["gt_views"] == 4
    for e in straight["log"]:
        assert all(math.isfinite(e[k]) for k in ("total", "img_loss", "depth_loss", "reg_loss"))
        assert e["depth_loss"] > 0 and e["n_faces"] > 0 and e["raster_dropped"] == 0
        assert e["nonfinite_grads"] == 0 and e["sdf_net_grad_norm"] > 0
    assert straight["final_faces"] > 0


def test_cli_second_layer_resume_equals_a_straight_run_bit_for_bit(files, runs):
    straight, first, resumed, _ = runs
    assert resumed["start_it"] == 2 and [e["it"] for e in resumed["log"]] == [2, 3]
    for a, b in zip(straight["log"], first["log"] + resumed["log"]):
        assert {k: a[k] for k in a if k != "s"} == {k: b[k] for k in b if k != "s"}
    sa = torch.load(str(files / "straight" / "state.pt"), weights_only=True)
    sb = torch.load(str(files / "split" / "state.pt"), weights_only=True)
    for key in ("params_geo", "params_mat", "light_base", "optimizers", "draws"):
        la, lb = _tree_leaves(sa[key]), _tree_leaves(sb[key])
        assert len(la) == len(lb) > 0, key
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), key
    assert sa["extra"] == sb["extra"]


def test_cli_flexicubes_trains_with_second_layer_and_counts_dropped_pairs(runs):
    """FlexiCubes with both layers and depth, and a 256-pair buffer: the
    pairs past it are dropped in every view's both layers and counted."""
    flexi = runs[3]
    assert [e["it"] for e in flexi["log"]] == [0, 1]
    for e in flexi["log"]:
        assert all(math.isfinite(e[k]) for k in ("total", "img_loss", "depth_loss", "reg_loss"))
        assert e["depth_loss"] > 0 and e["n_surf_cubes"] > 0 and e["raster_dropped"] > 0
