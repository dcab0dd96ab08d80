"""The port imports nothing of JAX or of the JAX package, and its own copies
of the JAX package's numpy-only grid modules equal the originals.

The import check runs in a fresh interpreter with a ``sys.meta_path`` finder
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

from gshell_tpu.geometry import tet_grid as jgrid
from gshell_tpu.geometry import tet_tables as jtables
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
