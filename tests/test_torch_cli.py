"""The port's command-line path on the CPU, at a tiny configuration (64²,
tet grid 16, a small SDF MLP, 4 iterations, 4 ground-truth views of a small
sphere): ``train_gshell`` writes the OBJ, the state and ``probe.hdr``; two
iterations, then ``--resume`` for two more, give parameters, Adam states
and logged losses equal bit for bit to four straight (with PyTorch's
deterministic algorithms, which the CPU's multi-threaded index accumulation
otherwise is not); ``eval_reconstruction`` writes ``metrics.txt`` with a
finite PSNR and a Chamfer.  Also: the splat-coverage diagnostic, the other
fields (a direct SDF, an mSDF MLP) trained, resumed and evaluated, the
device check (no silent CPU fallback) and the parsing of boolean options
and ``--spp``."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.geometry.geometry import GeometryConfig as JGeometryConfig
from gshell_tpu.geometry.geometry import GShellGeometry as JGShellGeometry
from gshell_tpu_torch import eval_reconstruction, train_gshell
from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
from gshell_tpu_torch.ops.mesh_ops import sample_surface
from gshell_tpu_torch.train.setup import parse_bool
from gshell_tpu_torch.utils.image import load_hdr
from gshell_tpu_torch.utils.rng import ReplayDraws
from gshell_tpu_torch.utils.synthetic_gt import skirt, sphere, write_obj
from torch_parity import _draw, n

TINY = {"iter": 4, "save_interval": 2, "train_res": [64, 64], "batch": 1, "learning_rate": [0.03, 0.005],
        "background": "white", "denoiser": "bilateral", "n_samples": 2, "gshell_grid": 16, "mesh_scale": 1.4,
        "use_sdf_mlp": True, "shade_budget": 0.5, "gt_shadows": True, "n_freq": 4, "d_hidden": 32,
        "n_hidden": 2, "skip_in": [1], "sdf_mlp_pretrain_steps": 10, "boxscale": [1, 1, 1],
        "aabb": [-1, -1, -1, 1, 1, 1]}


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
    d = tmp_path_factory.mktemp("cli")
    (d / "tiny.json").write_text(json.dumps(TINY))
    write_obj(str(d / "sphere.obj"), *sphere(16, 12))
    return d


def _train_argv(files, out, *extra):
    return ["--config", str(files / "tiny.json"), "--ref-mesh", str(files / "sphere.obj"), "--out-dir",
            str(files / out), "--device", "cpu", "--log-interval", "1", *extra]


@pytest.fixture(scope="module")
def runs(files):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    mp = pytest.MonkeyPatch()
    mp.setattr(train_gshell, "GT_VIEWS", 4)  # a module-scoped fixture cannot take ``monkeypatch``
    try:
        straight = train_gshell.main(_train_argv(files, "straight"))
        first = train_gshell.main(_train_argv(files, "split", "-i", "2", "--snapshot-images", "no"))
        resumed = train_gshell.main(_train_argv(files, "split", "--resume"))
    finally:
        mp.undo()
        torch.use_deterministic_algorithms(prev)
    return straight, first, resumed


def test_cli_writes_mesh_state_and_probe(files, runs):
    straight = runs[0]
    out = files / "straight"
    assert [e["it"] for e in straight["log"]] == [0, 1, 2, 3] and straight["start_it"] == 0
    for e in straight["log"]:
        assert all(math.isfinite(e[k]) for k in ("total", "img_loss", "reg_loss"))
        assert e["n_faces"] > 0 and e["raster_dropped"] == 0 and e["splat_cells"] > 0
    text = (out / "mesh_000004.obj").read_text()
    assert text.count("\nf ") == straight["final_faces"] > 0
    assert (out / "mesh_000002.obj").exists() and (out / "img_000002.png").exists()
    assert load_hdr(str(out / "probe.hdr")).shape == (512, 512, 3)
    assert torch.load(str(out / "state.pt"), weights_only=True)["step"] == 4
    gt = straight["gt_splat"]
    assert straight["gt_views"] == 4 and gt["splat_cells"] > 0 and 0 <= gt["splat_singletons"] <= gt["splat_cells"]
    assert gt["splat_cells"] * gt["splat_samples_per_cell"] == pytest.approx(1 << 17)


def test_cli_resume_equals_a_straight_run_bit_for_bit(files, runs):
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


def test_eval_writes_metrics_psnr_and_chamfer(files, runs, monkeypatch):
    monkeypatch.setattr(eval_reconstruction, "CHAMFER_SAMPLES", 2048)
    out = files / "validate"
    res = eval_reconstruction.main([
        "--state", str(files / "straight" / "state.pt"), "--config", str(files / "tiny.json"),
        "--synthetic-ref-mesh", str(files / "sphere.obj"), "--gt-mesh", str(files / "sphere.obj"),
        "--gt-unit-size", "--n-views", "2", "--out-dir", str(out),
        "--device", "cpu", "--dump-images", "1"])
    lines = (out / "metrics.txt").read_text().splitlines()
    assert lines[0] == "ID, MSE, PSNR" and lines[-1].startswith("AVERAGES:") and len(lines) == 4
    assert math.isfinite(res["psnr"]) and res["psnr"] > 5.0
    assert math.isfinite(res["chamfer"]) and res["chamfer"] > 0.0
    assert (out / "val_001.png").exists()


def test_splat_coverage_counts_and_unchanged_occupancy():
    """The coverage the port reports beside the splat occupancy, on a skirt,
    counted again with numpy; the occupancy itself equals the JAX package's
    on the same (replayed) samples."""
    v, f = skirt(48, 24)
    v = v * 0.5
    mask = np.arange(len(f)) % 5 != 0
    key = jax.random.PRNGKey(3)

    def source(kind, name, shape, lo, hi):
        k_face, k_uv = jax.random.split(key)
        return _draw(kind, k_face if name.endswith("face") else k_uv, shape, lo, hi)

    geo = GShellGeometry(GeometryConfig(grid_res=4), "cpu")
    occ, amin, asz, cov = geo.splat_occupancy(ReplayDraws(source), torch.as_tensor(v),
                                              torch.as_tensor(f).long(), torch.as_tensor(mask), res=33,
                                              n_samples=4096)
    jgeo = JGShellGeometry(JGeometryConfig(grid_res=4))
    occ_j, amin_j, asz_j = jgeo.splat_occupancy(key, jnp.asarray(v), jnp.asarray(f), jnp.asarray(mask),
                                                res=33, n_samples=4096)
    np.testing.assert_array_equal(n(occ), np.asarray(occ_j))
    assert (amin, asz) == (amin_j, asz_j)
    p = n(sample_surface(ReplayDraws(source), torch.as_tensor(v), torch.as_tensor(f).long(), 4096,
                         face_mask=torch.as_tensor(mask)))
    ijk = np.clip(((p - np.asarray(amin, np.float32)) / np.asarray(asz, np.float32) * 32).astype(np.int64), 0, 32)
    counts = np.bincount((ijk[:, 0] * 33 + ijk[:, 1]) * 33 + ijk[:, 2], minlength=33**3)
    assert int(cov["splat_cells"]) == int((counts > 0).sum()) == int(n(occ).sum())
    assert int(cov["splat_singletons"]) == int((counts == 1).sum())
    assert float(cov["splat_samples_per_cell"]) == pytest.approx(4096 / (counts > 0).sum())


def _train_resume_and_evaluate(files, tmp_path, monkeypatch, cfg: dict) -> dict:
    """Train one iteration, resume for a second and bake the textures at
    64², evaluate one held-out view and the Chamfer through the CLI → the
    state's record."""
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(train_gshell, "GT_VIEWS", 2)
    monkeypatch.setattr(eval_reconstruction, "CHAMFER_SAMPLES", 1024)
    argv = _train_argv(files, "never", "--snapshot-images", "no")
    argv[argv.index("--config") + 1] = str(tmp_path / "cfg.json")
    argv[argv.index("--out-dir") + 1] = str(tmp_path / "run")
    first = train_gshell.main(argv + ["-i", "1"])
    resumed = train_gshell.main(argv + ["-i", "2", "--resume", "--bake-texture", "64"])
    assert first["start_it"] == 0 and resumed["start_it"] == 1 and [e["it"] for e in resumed["log"]] == [1]
    assert resumed["bake"]["faces"] > 0 and resumed["bake"]["finite"]
    assert (tmp_path / "run" / "mesh_textured.obj").exists() and (tmp_path / "run" / "texture_kd.png").exists()
    for e in first["log"] + resumed["log"]:
        assert all(math.isfinite(e[k]) for k in ("total", "img_loss", "reg_loss")) and e["nonfinite_grads"] == 0
        assert e["n_faces"] > 0
    res = eval_reconstruction.main([
        "--state", str(tmp_path / "run" / "state.pt"), "--config", str(tmp_path / "cfg.json"),
        "--synthetic-ref-mesh", str(files / "sphere.obj"), "--gt-mesh", str(files / "sphere.obj"),
        "--n-views", "1", "--out-dir", str(tmp_path / "val"), "--device", "cpu"])
    assert math.isfinite(res["psnr"]) and math.isfinite(res["chamfer"]) and res["chamfer"] > 0
    return torch.load(str(tmp_path / "run" / "state.pt"), weights_only=True)


@pytest.mark.parametrize("setting, keys", [
    ({"use_sdf_mlp": False}, ["deform", "msdf", "sdf"]), ({"use_msdf_mlp": True}, ["deform", "msdf_net", "sdf_net"]),
    ({"use_sdf_mlp": False, "use_msdf_mlp": True}, ["deform", "msdf_net", "sdf"]),
])
def test_field_settings_train_resume_and_evaluate(files, tmp_path, monkeypatch, setting, keys):
    """A direct SDF and an mSDF MLP, alone and together: the snapshot holds
    those fields (and no other), the eikonal runs only with an SDF MLP."""
    # 200 pretrain steps, as the FlexiCubes CLI test takes: after TINY's 10 the
    # SDF MLP drawn first (with no direct mSDF drawn before it) has no surface yet
    rec = _train_resume_and_evaluate(files, tmp_path, monkeypatch,
                                     {**TINY, "sdf_mlp_pretrain_steps": 200, **setting})
    assert rec["step"] == 2 and sorted(rec["params_geo"]) == keys
    if "sdf" in keys:
        assert rec["params_geo"]["sdf"].shape == (17 ** 3,)


def test_train_rejects_a_test_set(files, capsys):
    """The JAX CLI accepts ``--testset-path`` and does nothing with it; the
    port's points to the eval instead of ignoring it."""
    with pytest.raises(SystemExit) as e:
        train_gshell.main(_train_argv(files, "never", "--testset-path", str(files)))
    assert e.value.code == 2 and "eval_reconstruction --testset-path" in capsys.readouterr().err


def test_no_card_and_no_device_option_exits(files, monkeypatch):
    """Without ``--device`` the entry points ask for the card; where there is
    none they exit with a message, they do not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _train_argv(files, "never")
    argv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_gshell.main(argv)
    with pytest.raises(SystemExit, match="no CUDA device"):
        eval_reconstruction.main(["--state", "none.pt", "--config", str(files / "tiny.json")])
    assert not (files / "never").exists()


@pytest.mark.parametrize("text, value", [
    ("0", False), ("false", False), ("No", False), ("off", False),
    ("1", True), ("TRUE", True), ("yes", True), ("on", True),
])
def test_parse_bool(text, value):
    assert parse_bool(text) is value


def test_boolean_options_parse_words():
    p = train_gshell.build_parser()
    assert p.parse_args([]).snapshot_images is True and p.parse_args([]).resume is False
    assert p.parse_args(["--snapshot-images", "no"]).snapshot_images is False
    assert p.parse_args(["--snapshot-images", "0"]).snapshot_images is False
    assert p.parse_args(["--resume"]).resume is True and p.parse_args(["--resume", "false"]).resume is False
    assert p.parse_args(["--flexicubes", "0"]).flexicubes is False
    e = eval_reconstruction.build_parser()
    base = ["--state", "s.pt"]
    assert e.parse_args(base + ["--dump-images", "false"]).dump_images is False
    assert e.parse_args(base + ["--gt-unit-size", "yes"]).gt_unit_size is True
    assert e.parse_args(base + ["--gt-unit-size"]).gt_unit_size is True
    with pytest.raises(SystemExit):
        p.parse_args(["--resume", "maybe"])


def test_eval_spp_zero_is_an_error_not_the_config_value(capsys):
    with pytest.raises(SystemExit) as e:
        eval_reconstruction.main(["--state", "none.pt", "--spp", "0", "--device", "cpu"])
    assert e.value.code == 2 and "--spp must be >= 1 (got 0)" in capsys.readouterr().err
