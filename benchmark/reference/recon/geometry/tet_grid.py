"""Structured tetrahedral grid with static, analytically indexed topology.

The port's own copy of what it uses from ``gshell_tpu/geometry/tet_grid.py``
(numpy only), so that ``gshell_tpu_torch`` imports nothing of the JAX
package; ``tests/test_torch_imports.py`` holds the two equal.  The native
``libgridgen`` grid generator is left out: the port builds its grids with
``build_topology=False``, which never reaches it.

A Freudenthal (Kuhn) lattice: each cube of a regular ``res³`` grid splits
into 6 tetrahedra along the main diagonal, so every tet edge joins a lattice
vertex ``v`` to ``v + o`` for one of 7 offsets, and the edge list and the
(tet → 6 edge ids) incidence are closed-form ravelings.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

# The 7 lattice edge-offset classes of the Freudenthal decomposition.
EDGE_OFFSETS = np.array(
    [
        [1, 0, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 1, 0],
        [1, 0, 1],
        [0, 1, 1],
        [1, 1, 1],
    ],
    dtype=np.int64,
)

# 6 monotone paths 000→111 (axis permutation order), each a tetrahedron.
_PATHS = list(itertools.permutations([0, 1, 2]))


@dataclasses.dataclass(frozen=True)
class TetGrid:
    """Static topology of a Freudenthal tet lattice over ``[-0.5, 0.5]³``.

    ``tets`` / ``tet_edges`` / ``edges`` are ``None`` after
    ``build_tet_grid(..., build_topology=False)``: the extractor
    (``gshell_tets.py``) computes incidence closed-form."""

    res: int
    verts: np.ndarray  # (N, 3) float32, lattice positions in [-0.5, 0.5]^3
    tets: np.ndarray | None  # (T, 4) int32
    tet_edges: np.ndarray | None  # (T, 6) int32 — edge ids [01,02,03,12,13,23]
    edges: np.ndarray | None  # (E, 2) int32 — unique edges, low index first

    @property
    def n_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def n_tets(self) -> int:
        return 6 * self.res**3

    @property
    def n_edges(self) -> int:
        return int(_edge_class_bases(self.res)[-1])


def _edge_class_bases(res: int) -> np.ndarray:
    """Start offset of each edge class in the global edge numbering."""
    n = res + 1
    counts = [(n - o[0]) * (n - o[1]) * (n - o[2]) for o in EDGE_OFFSETS]
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _edge_id(res: int, lo_xyz: np.ndarray, cls: np.ndarray, bases: np.ndarray) -> np.ndarray:
    """Edge id from its lower-corner lattice coords and offset class."""
    n = res + 1
    o = EDGE_OFFSETS[cls]
    dims1 = n - o[..., 1]
    dims2 = n - o[..., 2]
    local = (lo_xyz[..., 0] * dims1 + lo_xyz[..., 1]) * dims2 + lo_xyz[..., 2]
    return bases[cls] + local


def build_tet_grid(res: int, dtype=np.float32, build_topology: bool = True) -> TetGrid:
    """The lattice's vertices and, with ``build_topology``, its
    6-tets-per-cube decomposition and analytic edge incidence (numpy).
    ``build_topology=False`` skips the O(res³) tets/tet_edges/edges tables,
    which the training extractor never reads."""
    n = res + 1
    axis = np.linspace(-0.5, 0.5, n, dtype=dtype)
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    if not build_topology:
        return TetGrid(res=res, verts=verts, tets=None, tet_edges=None, edges=None)
    vid = np.arange(n * n * n, dtype=np.int64).reshape(n, n, n)

    # Cube lower corners
    cx, cy, cz = np.meshgrid(
        np.arange(res, dtype=np.int64),
        np.arange(res, dtype=np.int64),
        np.arange(res, dtype=np.int64),
        indexing="ij",
    )
    base = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)  # (C, 3)

    # 6 tets per cube; vertices of tet p = cumulative steps of the path.
    tets = np.empty((base.shape[0], 6, 4), dtype=np.int64)
    for p, path in enumerate(_PATHS):
        corner = np.zeros((4, 3), dtype=np.int64)
        for s, ax in enumerate(path):
            corner[s + 1] = corner[s]
            corner[s + 1, ax] += 1
        for s in range(4):
            c = base + corner[s]
            tets[:, p, s] = vid[c[:, 0], c[:, 1], c[:, 2]]
    tets = tets.reshape(-1, 4)

    # Edge ids for the 6 edges [01, 02, 03, 12, 13, 23] of each tet.  Offsets
    # within a tet are monotone, so |diff| is one of the 7 classes.
    bases = _edge_class_bases(res)
    key_to_cls = np.full(8, -1, dtype=np.int64)
    for i, o in enumerate(EDGE_OFFSETS):
        key_to_cls[o[0] * 4 + o[1] * 2 + o[2]] = i
    xyz = np.stack(np.unravel_index(tets, (n, n, n)), axis=-1)  # (T, 4, 3)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    tet_edges = np.empty((tets.shape[0], 6), dtype=np.int64)
    for k, (a, b) in enumerate(pairs):
        pa, pb = xyz[:, a], xyz[:, b]
        off = np.abs(pb - pa)
        cls = key_to_cls[off[:, 0] * 4 + off[:, 1] * 2 + off[:, 2]]
        assert (cls >= 0).all()
        tet_edges[:, k] = _edge_id(res, np.minimum(pa, pb), cls, bases)

    # Unique edge list, enumerated per class.
    edge_chunks = []
    for o in EDGE_OFFSETS:
        lo_ids = vid[: n - o[0], : n - o[1], : n - o[2]].reshape(-1)
        hi_ids = vid[o[0]:, o[1]:, o[2]:].reshape(-1)
        edge_chunks.append(np.stack([lo_ids, hi_ids], axis=-1))
    edges = np.concatenate(edge_chunks, axis=0)

    return TetGrid(
        res=res,
        verts=verts,
        tets=tets.astype(np.int32),
        tet_edges=tet_edges.astype(np.int32),
        edges=edges.astype(np.int32),
    )


def default_capacities(res: int, n_tets: int, n_edges: int, safety: float = 1.0):
    """Fixed extraction capacities ``(max_valid_tets, max_crossing_edges)``.

    One iso-surface sheet through the volume costs ~9·res² tets and ~6·res²
    edges; the budget below covers ≈2.67 sheets of tets and ≈2.0 of edges at
    ``safety=1.0``, capped at the full grid."""
    max_tets = min(n_tets, int(24 * res * res * safety))
    max_verts = min(n_edges, int(12 * res * res * safety))
    return max_tets, max_verts
