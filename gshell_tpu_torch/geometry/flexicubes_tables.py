"""FlexiCubes / Dual-Marching-Cubes lookup tables, DERIVED algorithmically.

The port's own copy of ``gshell_tpu/geometry/flexicubes_tables.py`` (numpy only),
so that ``gshell_tpu_torch`` imports nothing of the JAX package;
``tests/test_torch_imports.py`` holds the two copies equal.

The reference ships the 256-case DMC tables as literal data
(``geometry/flexicubes_table.py``).  Here the same tables are *derived from
first principles* at import time (cheap, pure numpy):

  * A cube case is the 8-bit occupancy code (occ = s < 0, i.e. inside).
  * Each dual vertex corresponds to one connected surface patch inside the
    cube.  Patches are in bijection with connected components of the INSIDE
    corners (corner graph = cube edges), each patch owning the crossing
    edges incident to its component — EXCEPT the four "antipodal hole" cases
    (two isolated, diagonally-opposite OUTSIDE corners: cases 126, 189, 219,
    231) where the two patches are keyed by the outside corners instead.
  * The C16/C19 inter-cube ambiguity (``check_table``): a case needs
    checking iff it has exactly ONE ambiguous face (diagonal in/out pattern)
    AND its inside corners form one component while the outside corners form
    two.  The stored direction is the outward normal of the ambiguous face,
    and the corrected case is the complement (255 − case), matching the
    reference resolution (``gshell_flexicubes.py:265-306``).

The mSDF face-cutting tables (``gflex_*``) are shared with the marching-tets
cutter (``tet_tables.TRIANGLE_TABLE_TRI``), as in the reference.

A parity test (tests/test_flexicubes_tables.py) verifies the derived tables
against the reference data when the reference checkout is available.
"""
from __future__ import annotations

import numpy as np

from .tet_tables import NUM_TRIANGLES_TRI_TABLE, TRIANGLE_TABLE_TRI

# Corner i is at coords (i&1, (i>>1)&1, (i>>2)&1)  — matches the reference
# cube_corners ordering (gshell_flexicubes.py:83-84).
CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int64,
)

# The 12 cube edges in the reference's order (gshell_flexicubes.py:86-87).
CUBE_EDGES = np.array(
    [[0, 1], [1, 5], [4, 5], [0, 4], [2, 3], [3, 7], [6, 7], [2, 6],
     [2, 0], [3, 1], [7, 5], [6, 4]],
    dtype=np.int64,
)

# Faces: corner ids in cyclic order; face id = axis*2 + side with outward
# normal dir_of_face (only relative geometry matters for the derivation).
_FACES = [
    ([0, 2, 6, 4], (-1, 0, 0)),
    ([1, 3, 7, 5], (1, 0, 0)),
    ([0, 1, 5, 4], (0, -1, 0)),
    ([2, 3, 7, 6], (0, 1, 0)),
    ([0, 1, 3, 2], (0, 0, -1)),
    ([4, 5, 7, 6], (0, 0, 1)),
]

_ADJ = [
    [j for j in range(8) if int(np.abs(CUBE_CORNERS[i] - CUBE_CORNERS[j]).sum()) == 1]
    for i in range(8)
]

_ANTIPODAL = {(0, 7), (1, 6), (2, 5), (3, 4)}


def _components(case: int, val: int):
    occ = [(case >> i) & 1 for i in range(8)]
    seen = [False] * 8
    comps = []
    for i in range(8):
        if occ[i] == val and not seen[i]:
            stack, comp = [i], []
            seen[i] = True
            while stack:
                v = stack.pop()
                comp.append(v)
                for u in _ADJ[v]:
                    if occ[u] == val and not seen[u]:
                        seen[u] = True
                        stack.append(u)
            comps.append(sorted(comp))
    return comps


def _patch_groups(case: int):
    """Crossing-edge groups (one per dual vertex) for a cube case."""
    occ = [(case >> i) & 1 for i in range(8)]
    inside = _components(case, 1)
    outside = _components(case, 0)
    antipodal_holes = (
        len(inside) == 1
        and len(outside) == 2
        and all(len(c) == 1 for c in outside)
        and tuple(sorted(c[0] for c in outside)) in _ANTIPODAL
    )
    comps, side = (outside, 0) if antipodal_holes else (inside, 1)
    groups = []
    for comp in comps:
        g = [
            e
            for e, (a, b) in enumerate(CUBE_EDGES.tolist())
            if occ[a] != occ[b]
            and ((occ[a] == side and a in comp) or (occ[b] == side and b in comp))
        ]
        if g:
            groups.append(sorted(g))
    return groups


def _ambiguous_faces(case: int):
    occ = [(case >> i) & 1 for i in range(8)]
    out = []
    for f, (cs, normal) in enumerate(_FACES):
        pat = [occ[c] for c in cs]
        if pat == [1, 0, 1, 0] or pat == [0, 1, 0, 1]:
            out.append((f, normal))
    return out


def _build_tables():
    dmc = np.full((256, 4, 7), -1, np.int32)
    num_vd = np.zeros((256,), np.int32)
    check = np.zeros((256, 5), np.int32)
    for c in range(256):
        groups = _patch_groups(c)
        num_vd[c] = len(groups)
        for k, g in enumerate(groups):
            dmc[c, k, : len(g)] = g
        amb = _ambiguous_faces(c)
        if (
            len(amb) == 1
            and len(_components(c, 1)) == 1
            and len(_components(c, 0)) == 2
        ):
            _, normal = amb[0]
            check[c] = [1, normal[0], normal[1], normal[2], 255 - c]
    return dmc, num_vd, check


DMC_TABLE, NUM_VD_TABLE, CHECK_TABLE = _build_tables()

# mSDF cutting of (triangular) faces — identical case structure to the
# marching-tets tri cutter; the reference reuses the same data as
# gflex_configuration_table (flexicubes_table.py:794-812).
GFLEX_CONFIGURATION_TABLE = TRIANGLE_TABLE_TRI
GFLEX_NUM_TRIANGLES_TABLE = NUM_TRIANGLES_TRI_TABLE

# Quad split index patterns (gshell_flexicubes.py:78-81).
QUAD_SPLIT_1 = np.array([0, 1, 2, 0, 2, 3], np.int32)
QUAD_SPLIT_2 = np.array([0, 1, 3, 3, 1, 2], np.int32)
QUAD_SPLIT_TRAIN = np.array([0, 1, 1, 2, 2, 3, 3, 0], np.int32)
