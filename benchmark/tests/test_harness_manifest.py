"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of cells, configurations, traffic mixes and metric readers by
name."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def manifest() -> dict:
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def one_line(text: str, most: int = 200) -> bool:
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == KEYS["top"]
    assert m["command"][:2] == ["python3", "-m"] and all(one_line(w) for w in m["command"])
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[section]:
            assert set(e) - {"workloads"} == KEYS[section] or set(e) == KEYS[section], (section, e)
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e
            for key in ("why", "layer", "source"):
                if key in e:
                    assert one_line(e[key]), (e["name"], key)
    assert len(names) == len(set(names))
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in m["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["file"].startswith("benchmark/")
    bounds = {e["name"]: e["bound"] for e in m["end_to_end"]}
    assert bounds["setup_s"] <= 0.25 and all(0.01 <= b <= 0.25 for b in bounds.values())
    assert len(json.dumps(m)) < 64 * 1024


def test_every_cell_finds_its_files_and_reports_what_its_metrics_move():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        found = harness.find_cell(w["name"])
        e2e = {e["name"] for e in harness.cell_metrics(found, "end_to_end")}
        assert {"setup_s", found["traffic"]["rate_metric"]} <= e2e
        per_layer = harness.cell_metrics(found, "per_layer")
        assert per_layer and all(p["moves"] in e2e for p in per_layer)
        for p in per_layer:
            assert callable(harness.metric_reader(p["name"]))
        assert set(found["limits"]["limits"]) == {"loss", "grad", "change"}
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "runners", found["config_file"]["runner"] + ".py"))


def test_configurations_name_source_reduced_and_deployment():
    for c in manifest()["configs"]:
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and data["assumed"] and data["deployment"]
        source = harness.load_json(os.path.join(ROOT, data["source_copy"]))
        for k, v in source.items():  # the repository's twin of the source, key for key
            assert data[k] == v, k
    assert harness.load_json(os.path.join(ROOT, "benchmark/configs/gmd_upper_occgrid_bf16.json"))[
        "deployment_ranks"] == 8


def test_a_cell_dropped_in_is_found_with_no_file_edited(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, added as
    files and manifest entries alone, are found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    m = manifest()
    cfg = harness.load_json(os.path.join(ROOT, "benchmark/configs/deepfashion_mc_tets128.json"))
    cfg.update(name="deepfashion_mc_tets96", gshell_grid=96)
    (root / "benchmark/configs/deepfashion_mc_tets96.json").write_text(json.dumps(cfg))
    traffic = harness.load_json(os.path.join(harness.BENCH_DIR, "traffic/recon_closed_loop.json"))
    (root / "benchmark/traffic/recon_few_views.json").write_text(json.dumps(dict(traffic, n_views=8)))
    (root / "benchmark/cells/tets96_few_views.json").write_text(
        json.dumps({"limits": {"loss": 1, "grad": 1, "change": 1}, "readings": {}}))
    (root / "benchmark/metrics/recon.views_per_step.py").write_text(
        "def read(ctx):\n    return float(ctx.found['traffic']['n_views'])\n")
    m["configs"].append({"name": "deepfashion_mc_tets96", "source": m["configs"][0]["source"],
                         "file": "benchmark/configs/deepfashion_mc_tets96.json", "reduced": [], "why": "grid 96"})
    m["workloads"].append({"name": "tets96_few_views", "config": "deepfashion_mc_tets96",
                           "traffic": "recon_few_views", "chips": 1, "why": "eight views"})
    m["per_layer"].append({"name": "recon.views_per_step", "unit": "views", "better": "higher",
                           "source": "program_counter", "layer": "device", "moves": "recon_it_per_s",
                           "workloads": ["tets96_few_views"]})
    m["end_to_end"][1]["workloads"].append("tets96_few_views")
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    found = harness.find_cell("tets96_few_views", root=str(root))
    assert found["config_file"]["gshell_grid"] == 96 and found["traffic"]["n_views"] == 8
    assert found["config_file"]["runner"] == "reconstruction"
    names = [p["name"] for p in harness.cell_metrics(found, "per_layer")]
    assert names == ["recon.views_per_step"]
    ctx = harness.Context(found=found)
    assert harness.metric_reader("recon.views_per_step", found["bench_dir"])(ctx) == 8.0
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing that was there changed


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(harness.BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_port():
    for path in _sources():
        assert not _imports(path) & set(harness.FORBIDDEN), path
    for path in list(_sources("reference")) + list(_sources("inputs")) + [
            os.path.join(harness.BENCH_DIR, f) for f in ("compare.py", "draws.py", "yardstick.py", "trace.py")]:
        assert "gshell_tpu_torch" not in _imports(path), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "gshell_tpu_torch_extra", types.ModuleType("gshell_tpu_torch_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert harness.forbidden_modules() == ["jaxlib"]


@pytest.mark.parametrize("workload", ["tets128_train", "gmd_train"])
def test_run_without_a_card_exits_nonzero_and_prints_no_result(workload):
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
