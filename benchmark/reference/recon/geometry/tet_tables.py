"""Marching-tetrahedra + G-Shell mSDF-cutting lookup tables.

The port's own copy of ``gshell_tpu/geometry/tet_tables.py`` (numpy only),
so that ``gshell_tpu_torch`` imports nothing of the JAX package;
``tests/test_torch_imports.py`` holds the two copies equal.

Numerical twins of the tables in the reference ``geometry/gshell_tets.py:82-194``
(triangle_table, mesh_edge_table, triangle_table_tri/quad, num_triangles_*,
base_tet_edges).  The tables are pure case data (published in the G-Shell /
DMTet papers); entries of ``-1`` are "unused slot" sentinels.

Index conventions (identical to the reference):
  * A tet's 6 edges are ordered [v0v1, v0v2, v0v3, v1v2, v1v3, v2v3]
    (``base_tet_edges`` = [0,1, 0,2, 0,3, 1,2, 1,3, 2,3]).
  * ``tetindex`` = sum(occ[v_i] * 2^i) over the 4 tet vertices, occ = sdf > 0.
  * ``triangle_table[tetindex]`` holds up to 2 triangles as *edge indices*
    (into the 6-edge list); each crossing edge owns one iso-surface vertex.
  * ``mesh_edge_table[tetindex]`` holds the boundary cycle of the (tri or
    quad) face patch inside the tet, again as edge indices.
  * The mSDF bit codes for face cutting use *flipped* bit order
    ([4,2,1] / [8,4,2,1]) — the reference notes the flip is "because the
    triangle table uses a different assumption by mistake"
    (``gshell_tets.py:609``); we reproduce it for numerical parity.
"""
import numpy as np

TRIANGLE_TABLE = np.array(
    [
        [-1, -1, -1, -1, -1, -1],
        [1, 0, 2, -1, -1, -1],
        [4, 0, 3, -1, -1, -1],
        [1, 4, 2, 1, 3, 4],
        [3, 1, 5, -1, -1, -1],
        [2, 3, 0, 2, 5, 3],
        [1, 4, 0, 1, 5, 4],
        [4, 2, 5, -1, -1, -1],
        [4, 5, 2, -1, -1, -1],
        [4, 1, 0, 4, 5, 1],
        [3, 2, 0, 3, 5, 2],
        [1, 3, 5, -1, -1, -1],
        [4, 1, 2, 4, 3, 1],
        [3, 0, 4, -1, -1, -1],
        [2, 0, 1, -1, -1, -1],
        [-1, -1, -1, -1, -1, -1],
    ],
    dtype=np.int32,
)

MESH_EDGE_TABLE = np.array(
    [
        [-1, -1, -1, -1, -1, -1],
        [1, 0, 2, 1, -1, -1],
        [4, 0, 3, 4, -1, -1],
        [1, 3, 4, 2, 1, -1],
        [3, 1, 5, 3, -1, -1],
        [2, 5, 3, 0, 2, -1],
        [1, 5, 4, 0, 1, -1],
        [4, 2, 5, 4, -1, -1],
        [4, 5, 2, 4, -1, -1],
        [4, 5, 1, 0, 4, -1],
        [3, 5, 2, 0, 3, -1],
        [1, 3, 5, 1, -1, -1],
        [4, 3, 1, 2, 4, -1],
        [3, 0, 4, 3, -1, -1],
        [2, 0, 1, 2, -1, -1],
        [-1, -1, -1, -1, -1, -1],
    ],
    dtype=np.int32,
)

# mSDF cutting of a *triangular* template face.  Vertex ids 0..2 are the face
# corners, 3..5 the boundary (mSDF zero-crossing) vertices on cycle edges
# (0,1), (1,2), (2,0).  Case index: FLIPPED bit code of (msdf>0) per corner.
TRIANGLE_TABLE_TRI = np.array(
    [
        [-1, -1, -1, -1, -1, -1],  # 000
        [4, 2, 5, -1, -1, -1],  # 001
        [3, 1, 4, -1, -1, -1],  # 010
        [3, 1, 2, 3, 2, 5],  # 011
        [0, 3, 5, -1, -1, -1],  # 100
        [0, 3, 4, 0, 4, 2],  # 101
        [0, 1, 4, 0, 4, 5],  # 110
        [0, 1, 2, -1, -1, -1],  # 111
    ],
    dtype=np.int32,
)

# mSDF cutting of a *quad* template face.  Vertex ids 0..3 corners, 4..7 the
# boundary vertices on cycle edges (0,1), (1,2), (2,3), (3,0).
TRIANGLE_TABLE_QUAD = np.array(
    [
        [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # 0000
        [6, 3, 7, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # 0001
        [5, 2, 6, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # 0010
        [5, 2, 7, 3, 7, 2, -1, -1, -1, -1, -1, -1],  # 0011
        [4, 1, 5, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # 0100
        [4, 1, 5, 4, 5, 7, 5, 6, 7, 7, 6, 3],  # 0101
        [4, 1, 2, 6, 4, 2, -1, -1, -1, -1, -1, -1],  # 0110
        [4, 1, 2, 7, 4, 2, 7, 2, 3, -1, -1, -1],  # 0111
        [0, 4, 7, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # 1000
        [0, 4, 6, 3, 0, 6, -1, -1, -1, -1, -1, -1],  # 1001
        [0, 4, 5, 0, 5, 2, 0, 2, 6, 0, 6, 7],  # 1010
        [0, 4, 5, 0, 5, 2, 0, 2, 3, -1, -1, -1],  # 1011
        [0, 1, 5, 7, 0, 5, -1, -1, -1, -1, -1, -1],  # 1100
        [0, 1, 5, 0, 5, 6, 0, 6, 3, -1, -1, -1],  # 1101
        [0, 1, 2, 0, 2, 6, 0, 6, 7, -1, -1, -1],  # 1110
        [0, 1, 2, 0, 2, 3, -1, -1, -1, -1, -1, -1],  # 1111
    ],
    dtype=np.int32,
)

NUM_TRIANGLES_TABLE = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], dtype=np.int32
)
NUM_TRIANGLES_TRI_TABLE = np.array([0, 1, 1, 2, 1, 2, 2, 1], dtype=np.int32)
NUM_TRIANGLES_QUAD_TABLE = np.array(
    [0, 1, 1, 2, 1, 4, 2, 3, 1, 2, 4, 3, 2, 3, 3, 2], dtype=np.int32
)

BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3], dtype=np.int32)
