"""Regular voxel grid with analytic cube/edge topology for FlexiCubes.

The port's own copy of ``gshell_tpu/geometry/cube_grid.py`` (numpy only),
so that ``gshell_tpu_torch`` imports nothing of the JAX package;
``tests/test_torch_imports.py`` holds the two copies equal.

Replaces the reference's ``construct_voxel_grid`` + per-step ``torch.unique``
edge identification (``gshell_flexicubes.py:103-134, 308-331``) with
closed-form lattice indexing, and — crucially for static shapes — replaces
the sort-based quad assembly (``_triangulate``, ref :492-503) with the
analytic 4-cube adjacency of each interior lattice edge:

  every interior edge of class x/y/z is shared by exactly 4 cubes whose
  linear ids ascend in a fixed pattern, and within each cube the edge has a
  fixed local index.  The reference's ``stable sort by edge id`` produces
  cubes in ascending id order — identical to the analytic order — so quads
  (and their winding fix) are bit-compatible without any sorting.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .flexicubes_tables import CUBE_CORNERS, CUBE_EDGES

# local-edge classes: which axis each of the 12 cube edges runs along
EDGE_AXIS = np.array([0, 2, 0, 2, 0, 2, 0, 2, 1, 1, 1, 1], np.int64)

# For a global edge of class axis a at lower lattice vertex (i,j,k), the 4
# adjacent cubes in ascending cube-id order, as (offset into the two
# transverse axes, local edge index).  Derived from CUBE_CORNERS/CUBE_EDGES;
# see module docstring.
#   x-edge: cubes (i, j-1, k-1)e6, (i, j-1, k)e4, (i, j, k-1)e2, (i, j, k)e0
#   y-edge: cubes (i-1, j, k-1)e10, (i-1, j, k)e9, (i, j, k-1)e11, (i, j, k)e8
#   z-edge: cubes (i-1, j-1, k)e5, (i-1, j, k)e1, (i, j-1, k)e7, (i, j, k)e3
EDGE_ADJ_CUBE_OFFSETS = {
    0: (np.array([[0, -1, -1], [0, -1, 0], [0, 0, -1], [0, 0, 0]]), np.array([6, 4, 2, 0])),
    1: (np.array([[-1, 0, -1], [-1, 0, 0], [0, 0, -1], [0, 0, 0]]), np.array([10, 9, 11, 8])),
    2: (np.array([[-1, -1, 0], [-1, 0, 0], [0, -1, 0], [0, 0, 0]]), np.array([5, 1, 7, 3])),
}


@dataclasses.dataclass(frozen=True)
class CubeGrid:
    res: int
    verts: np.ndarray  # ((R+1)³, 3) float32 in [-0.5, 0.5]³
    cubes: np.ndarray  # (R³, 8) int32 corner ids (CUBE_CORNERS order)
    cube_edges: np.ndarray  # (R³, 12) int32 global edge ids
    edges: np.ndarray  # (E, 2) int32 — classes x|y|z concatenated
    edge_interior: np.ndarray  # (E,) bool — has 4 adjacent cubes
    edge_adj_cubes: np.ndarray  # (E, 4) int32 cube ids (ascending; -1 pad)
    edge_adj_local: np.ndarray  # (E, 4) int32 local edge index in each cube

    @property
    def n_verts(self):
        return self.verts.shape[0]

    @property
    def n_cubes(self):
        return self.cubes.shape[0]

    @property
    def n_edges(self):
        return self.edges.shape[0]


def build_cube_grid(res: int, dtype=np.float32) -> CubeGrid:
    n = res + 1
    vid = np.arange(n**3, dtype=np.int64).reshape(n, n, n)
    axis = np.linspace(-0.5, 0.5, n, dtype=dtype)
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3)

    cx, cy, cz = np.meshgrid(*[np.arange(res, dtype=np.int64)] * 3, indexing="ij")
    base = np.stack([cx, cy, cz], -1).reshape(-1, 3)
    cubes = np.stack(
        [vid[base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz] for dx, dy, dz in CUBE_CORNERS],
        axis=1,
    )

    # global edge numbering: class x then y then z, raveled over lower vertex
    class_dims = [(res, n, n), (n, res, n), (n, n, res)]  # (x, y, z)
    bases = np.concatenate([[0], np.cumsum([np.prod(d) for d in class_dims])])

    def edge_id(axis_cls, lo):
        d = class_dims[axis_cls]
        return bases[axis_cls] + (lo[..., 0] * d[1] + lo[..., 1]) * d[2] + lo[..., 2]

    # per-cube 12 edge ids
    cube_edges = np.empty((cubes.shape[0], 12), np.int64)
    corner_xyz = CUBE_CORNERS
    for e in range(12):
        a, b = CUBE_EDGES[e]
        lo_off = np.minimum(corner_xyz[a], corner_xyz[b])
        lo = base + lo_off
        cube_edges[:, e] = edge_id(EDGE_AXIS[e], lo)

    # global edge list per class
    edges_list, interior_list, adj_c_list, adj_l_list = [], [], [], []
    for cls in range(3):
        d = class_dims[cls]
        ex, ey, ez = np.meshgrid(
            np.arange(d[0]), np.arange(d[1]), np.arange(d[2]), indexing="ij"
        )
        lo = np.stack([ex, ey, ez], -1).reshape(-1, 3)
        off = np.zeros(3, np.int64)
        off[cls] = 1
        hi = lo + off
        e2 = np.stack(
            [vid[lo[:, 0], lo[:, 1], lo[:, 2]], vid[hi[:, 0], hi[:, 1], hi[:, 2]]], -1
        )
        edges_list.append(e2)

        offs, locs = EDGE_ADJ_CUBE_OFFSETS[cls]
        adj = lo[:, None, :] + offs[None, :, :]  # (E_c, 4, 3)
        ok = ((adj >= 0) & (adj < res)).all(-1)  # per-neighbor validity
        cube_id = (adj[..., 0] * res + adj[..., 1]) * res + adj[..., 2]
        cube_id = np.where(ok, cube_id, -1)
        interior_list.append(ok.all(-1))
        adj_c_list.append(cube_id)
        adj_l_list.append(np.broadcast_to(locs, cube_id.shape).copy())

    return CubeGrid(
        res=res,
        verts=verts,
        cubes=cubes.astype(np.int32),
        cube_edges=cube_edges.astype(np.int32),
        edges=np.concatenate(edges_list).astype(np.int32),
        edge_interior=np.concatenate(interior_list),
        edge_adj_cubes=np.concatenate(adj_c_list).astype(np.int32),
        edge_adj_local=np.concatenate(adj_l_list).astype(np.int32),
    )


def default_cube_capacities(res: int, n_cubes: int, n_edges: int, safety: float = 1.0):
    max_cubes = min(n_cubes, int(16 * res * res * safety))
    max_edges = min(n_edges, int(12 * res * res * safety))
    return max_cubes, max_edges
