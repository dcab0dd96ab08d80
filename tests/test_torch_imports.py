"""The port imports nothing of JAX or of the JAX package, and its own copies
of the JAX package's numpy-only grid modules equal the originals.

The copies are ``tet_tables.py``, ``tet_grid.py`` (numpy path),
``flexicubes_tables.py``, ``cube_grid.py``, ``ops/uv_unwrap.py``,
``utils/config.py``, ``tools/make_synthetic_gt.py`` and the diffusion
dataset helpers.  The
import check runs in a fresh interpreter with a ``sys.meta_path`` finder
that raises on ``jax`` / ``jax.*`` / ``jaxlib`` and on ``gshell_tpu`` /
``gshell_tpu.*`` (``gshell_tpu_torch`` is allowed), then imports every module
of ``gshell_tpu_torch`` and ``chip_smoke.py``.  The copies are compared for
exact equality.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from gshell_tpu.geometry import cube_grid as jcube
from gshell_tpu.geometry import flexicubes_tables as jflex
from gshell_tpu.geometry import tet_grid as jgrid
from gshell_tpu.geometry import tet_tables as jtables
from gshell_tpu_torch.geometry import cube_grid as tcube
from gshell_tpu_torch.geometry import flexicubes_tables as tflex
from gshell_tpu_torch.geometry import tet_grid as tgrid
from gshell_tpu_torch.geometry import tet_tables as ttables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARDED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Forbidden(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "gshell_tpu"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Forbidden())
import gshell_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gshell_tpu_torch.__path__, "gshell_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "gshell_tpu"))
assert not bad, bad
print("ok", len(names))
"""


def test_port_and_chip_smoke_import_nothing_of_jax_or_gshell_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _GUARDED_IMPORT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok"), out.stdout
    assert int(out.stdout.split()[1]) >= 20  # every module was walked


@pytest.mark.parametrize("module", ["gshell_tpu_torch.parallel.sharding", "gshell_tpu_torch.parallel.spatial",
                                    "gshell_tpu_torch.data.multihost"])
def test_distributed_modules_import_nothing_of_jax_or_gshell_tpu(module):
    """The port's process-group modules, each alone under the guard."""
    code = _GUARDED_IMPORT.split("import gshell_tpu_torch")[0] + (
        f"import {module}\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'gshell_tpu'))\n"
        "assert not bad, bad\nprint('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok", out.stdout


def test_guard_catches_an_import_of_the_jax_package():
    """The finder itself works: importing the JAX package under it fails."""
    code = _GUARDED_IMPORT.split("import gshell_tpu_torch")[0] + "import gshell_tpu.geometry.tet_grid\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "must not import gshell_tpu" in out.stderr


@pytest.mark.parametrize("name", [
    "TRIANGLE_TABLE", "MESH_EDGE_TABLE", "TRIANGLE_TABLE_TRI", "TRIANGLE_TABLE_QUAD",
    "NUM_TRIANGLES_TABLE", "NUM_TRIANGLES_TRI_TABLE", "NUM_TRIANGLES_QUAD_TABLE", "BASE_TET_EDGES",
])
def test_tet_tables_copy_equals_the_jax_package(name):
    a, b = getattr(ttables, name), getattr(jtables, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_tet_tables_copy_has_every_table():
    names = lambda m: {k for k, v in vars(m).items() if isinstance(v, np.ndarray)}
    assert names(ttables) == names(jtables)


@pytest.mark.parametrize("res", [1, 4, 16, 64])
def test_lattice_verts_equal_the_jax_package(res):
    a = tgrid.build_tet_grid(res, build_topology=False)
    b = jgrid.build_tet_grid(res, build_topology=False)
    assert a.verts.dtype == b.verts.dtype
    np.testing.assert_array_equal(a.verts, b.verts)
    assert (a.n_verts, a.n_tets, a.n_edges) == (b.n_verts, b.n_tets, b.n_edges)
    assert a.tets is None and a.tet_edges is None and a.edges is None


@pytest.mark.parametrize("res", [1, 3, 8])
def test_lattice_topology_equals_the_jax_package(res):
    a = tgrid.build_tet_grid(res)
    b = jgrid.build_tet_grid(res, use_native=False)
    for k in ("verts", "tets", "tet_edges", "edges"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_grid_constants_equal_the_jax_package():
    np.testing.assert_array_equal(tgrid.EDGE_OFFSETS, jgrid.EDGE_OFFSETS)
    assert tgrid._PATHS == jgrid._PATHS


@pytest.mark.parametrize("res", [8, 32, 64, 96, 256])
@pytest.mark.parametrize("safety", [0.5, 1.0, 2.5])
def test_default_capacities_equal_the_jax_package(res, safety):
    g = jgrid.build_tet_grid(res, build_topology=False)
    assert tgrid.default_capacities(res, g.n_tets, g.n_edges, safety) == \
        jgrid.default_capacities(res, g.n_tets, g.n_edges, safety)


def _arrays(m):
    return {k for k, v in vars(m).items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("name", sorted(_arrays(jflex)))
def test_flexicubes_tables_copy_equals_the_jax_package(name):
    a, b = getattr(tflex, name), getattr(jflex, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_flexicubes_tables_and_cube_grid_copies_have_every_table():
    assert _arrays(tflex) == _arrays(jflex) and _arrays(tcube) == _arrays(jcube)
    for cls in range(3):
        for a, b in zip(tcube.EDGE_ADJ_CUBE_OFFSETS[cls], jcube.EDGE_ADJ_CUBE_OFFSETS[cls]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("module, name", [
    ("flexicubes_tables", "_components"), ("flexicubes_tables", "_patch_groups"),
    ("flexicubes_tables", "_ambiguous_faces"), ("flexicubes_tables", "_build_tables"),
    ("cube_grid", "build_cube_grid"), ("cube_grid", "default_cube_capacities"), ("cube_grid", "CubeGrid"),
])
def test_flexicubes_copies_have_the_originals_source(module, name):
    """The port's ``flexicubes_tables.py`` / ``cube_grid.py`` are the JAX
    package's, function for function (only the module docstring differs)."""
    import inspect

    ours, orig = ({"flexicubes_tables": tflex, "cube_grid": tcube}[module],
                  {"flexicubes_tables": jflex, "cube_grid": jcube}[module])
    assert inspect.getsource(getattr(ours, name)) == inspect.getsource(getattr(orig, name))


@pytest.mark.parametrize("res", [1, 4, 12, 80])
def test_cube_grid_copy_builds_the_jax_package_grid(res):
    a, b = tcube.build_cube_grid(res), jcube.build_cube_grid(res)
    for k in ("verts", "cubes", "cube_edges", "edges", "edge_interior", "edge_adj_cubes", "edge_adj_local"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert tcube.default_cube_capacities(res, a.n_cubes, a.n_edges) == \
        jcube.default_cube_capacities(res, b.n_cubes, b.n_edges)


_GUARDED_MAIN = _GUARDED_IMPORT.split("import gshell_tpu_torch")[0] + r"""
import runpy
sys.argv = [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "gshell_tpu"))
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("argv", [
    ["gshell_tpu_torch.train_gshell", "--help"],
    ["gshell_tpu_torch.eval_reconstruction", "--help"],
    ["gshell_tpu_torch.utils.synthetic_gt", "sphere", "{tmp}/sphere.obj"],
    ["gshell_tpu_torch.bake_grids", "--help"],
    ["gshell_tpu_torch.main_diffusion", "--help"],
    ["gshell_tpu_torch.eval_gmeshdiffusion", "--help"],
])
def test_entry_points_run_as_main_without_jax(tmp_path, argv):
    """``python -m`` of each entry point of the port, under the import guard."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = [a.format(tmp=tmp_path) for a in argv]
    out = subprocess.run([sys.executable, "-c", _GUARDED_MAIN] + args, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("ok"), out.stdout


def _make_synthetic_gt_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_synthetic_gt",
                                                  os.path.join(ROOT, "tools", "make_synthetic_gt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", ["sphere", "skirt", "blob"])
def test_synthetic_gt_copy_equals_the_original(tmp_path, shape):
    from gshell_tpu_torch.utils import synthetic_gt

    orig = _make_synthetic_gt_module()
    (va, fa), (vb, fb) = getattr(synthetic_gt, shape)(), getattr(orig, shape)()
    assert va.dtype == vb.dtype and fa.dtype == fb.dtype
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(fa, fb)
    synthetic_gt.write_obj(str(tmp_path / "a.obj"), va, fa)
    orig.write_obj(str(tmp_path / "b.obj"), vb, fb)
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()


def _jax_eval_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_eval_gmeshdiffusion",
                                                  os.path.join(ROOT, "eval_gmeshdiffusion.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["GShellGridDataset", "make_splits", "laplacian_smooth"])
def test_diffusion_copies_equal_their_originals(name):
    """The port's copies of ``GShellGridDataset`` / ``make_splits``
    (``gshell_tpu/data/datasets.py``) and ``laplacian_smooth``
    (``eval_gmeshdiffusion.py``) are the originals' source, line for line."""
    import inspect

    from gshell_tpu.data import datasets as jdatasets
    from gshell_tpu_torch import eval_gmeshdiffusion
    from gshell_tpu_torch.data import grids

    if name == "laplacian_smooth":
        ours, orig = eval_gmeshdiffusion.laplacian_smooth, _jax_eval_module().laplacian_smooth
    else:
        ours, orig = getattr(grids, name), getattr(jdatasets, name)
    assert inspect.getsource(ours) == inspect.getsource(orig)


def test_grid_dataset_and_splits_copies_behave_as_the_originals(tmp_path):
    from gshell_tpu.data import datasets as jdatasets
    from gshell_tpu_torch.data import grids

    rng = np.random.default_rng(0)
    files = []
    for i in range(6):
        f = tmp_path / f"g{i}.npz"
        np.savez(f, grid=rng.normal(size=(4, 4, 4, 2)).astype(np.float32),
                 occgrid=rng.normal(size=(8, 8, 8)).astype(np.float32))
        files.append(str(f))
    assert grids.make_splits(files, seed=3) == jdatasets.make_splits(files, seed=3)
    for use_occ in (True, False):
        a = grids.GShellGridDataset(files, use_occ).sample_batch(np.random.default_rng(1), 4)
        b = jdatasets.GShellGridDataset(files, use_occ).sample_batch(np.random.default_rng(1), 4)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_uv_unwrap_copy_has_the_originals_source():
    """The port's ``ops/uv_unwrap.py`` is the JAX package's, function for
    function (only the module docstring differs); its output on meshes is
    held equal in ``tests/test_torch_bake.py``."""
    import inspect

    from gshell_tpu.ops import uv_unwrap as orig
    from gshell_tpu_torch.ops import uv_unwrap as ours

    names = lambda m: sorted(k for k, v in vars(m).items() if inspect.isfunction(v) and v.__module__ == m.__name__)
    assert names(ours) == names(orig) == ["_face_adjacency", "_grow_charts", "_project_chart", "unwrap"]
    for name in names(orig):
        assert inspect.getsource(getattr(ours, name)) == inspect.getsource(getattr(orig, name)), name
