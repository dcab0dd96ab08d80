"""Generic UV unwrap for arbitrary triangle meshes (xatlas replacement;
the port's copy of ``gshell_tpu/ops/uv_unwrap.py``, numpy only, held equal
to the original function for function by ``tests/test_torch_imports.py``).

Runs on the host, once, after training, to bake the neural material into a
UV atlas (``train_gshell --bake-texture``):

  1. **Chart growth**: faces are grouped into charts by BFS over the
     face-adjacency graph, admitting a face while its normal stays within
     ``normal_cone_deg`` of the chart seed's normal.  The BFS is pure
     Python: its time grows with the face count.
  2. **Projection**: each chart is flattened onto the plane of its
     average normal.
  3. **Packing**: chart rectangles are sorted by height and shelf-packed
     into rows of a unit-square atlas with a texel gutter (no dilation:
     texels outside every chart stay background).

Returns per-face UV indices into a fresh UV vertex buffer (chart borders
are cut, as xatlas does).
"""
from __future__ import annotations

import numpy as np


def _face_adjacency(faces: np.ndarray) -> list[list[int]]:
    """Face → neighboring faces (shared undirected edge)."""
    edge_map: dict[tuple[int, int], list[int]] = {}
    for f, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            k = (min(u, v), max(u, v))
            edge_map.setdefault(k, []).append(f)
    adj: list[list[int]] = [[] for _ in range(len(faces))]
    for fs in edge_map.values():
        for i in range(len(fs)):
            for j in range(i + 1, len(fs)):
                adj[fs[i]].append(fs[j])
                adj[fs[j]].append(fs[i])
    return adj


def _grow_charts(
    verts: np.ndarray, faces: np.ndarray, normal_cone_deg: float
) -> np.ndarray:
    """BFS normal-cone chart segmentation → per-face chart id."""
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    fn = np.cross(e1, e2)
    norm = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(norm, 1e-12)
    cos_limit = np.cos(np.deg2rad(normal_cone_deg))

    adj = _face_adjacency(faces)
    chart = np.full(len(faces), -1, np.int64)
    n_charts = 0
    from collections import deque

    for seed in range(len(faces)):
        if chart[seed] >= 0:
            continue
        cid = n_charts
        n_charts += 1
        chart[seed] = cid
        seed_n = fn[seed]
        q = deque([seed])
        while q:
            f = q.popleft()
            for g in adj[f]:
                if chart[g] < 0 and float(fn[g] @ seed_n) >= cos_limit:
                    chart[g] = cid
                    q.append(g)
    return chart


def _project_chart(
    verts: np.ndarray, faces: np.ndarray, face_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Planar-project one chart.  Returns (uv (M, 2), local face idx (F, 3))."""
    vids = np.unique(faces[face_ids].reshape(-1))
    local = {int(v): i for i, v in enumerate(vids)}
    pts = verts[vids]

    e1 = verts[faces[face_ids, 1]] - verts[faces[face_ids, 0]]
    e2 = verts[faces[face_ids, 2]] - verts[faces[face_ids, 0]]
    fn = np.cross(e1, e2).sum(axis=0)
    n = fn / max(np.linalg.norm(fn), 1e-12)
    # ONB of the projection plane
    h = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u_ax = np.cross(n, h)
    u_ax /= max(np.linalg.norm(u_ax), 1e-12)
    v_ax = np.cross(n, u_ax)
    uv = np.stack([pts @ u_ax, pts @ v_ax], axis=1)
    uv -= uv.min(axis=0)
    lf = np.vectorize(local.__getitem__)(faces[face_ids])
    return uv, lf


def unwrap(
    verts: np.ndarray,
    faces: np.ndarray,
    normal_cone_deg: float = 60.0,
    gutter: float = 0.005,
) -> tuple[np.ndarray, np.ndarray]:
    """Unwrap a triangle mesh into a unit-square UV atlas.

    Args:
      verts: (V, 3) float.  faces: (F, 3) int.
    Returns:
      (uvs (M, 2) float in [0, 1]², uv_idx (F, 3) int) — per-face indices
      into the UV vertex buffer, xatlas-style (chart borders are cut).
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0, 3), np.int32)

    chart = _grow_charts(verts, faces, normal_cone_deg)
    n_charts = int(chart.max()) + 1

    chart_uvs: list[np.ndarray] = []
    chart_faces: list[np.ndarray] = []
    chart_fids: list[np.ndarray] = []
    sizes = np.zeros((n_charts, 2))
    for c in range(n_charts):
        fids = np.nonzero(chart == c)[0]
        uv, lf = _project_chart(verts, faces, fids)
        chart_uvs.append(uv)
        chart_faces.append(lf)
        chart_fids.append(fids)
        sizes[c] = uv.max(axis=0) if len(uv) else (0, 0)

    # shelf packing: sort by height, fill rows of width `atlas_w`
    total_area = float((sizes[:, 0] * sizes[:, 1]).sum())
    atlas_w = max(np.sqrt(total_area) * 1.15, sizes[:, 0].max() + 1e-12)
    order = np.argsort(-sizes[:, 1])
    offsets = np.zeros((n_charts, 2))
    x = y = row_h = 0.0
    g = gutter * atlas_w
    for c in order:
        w, h = sizes[c]
        if x + w > atlas_w and x > 0.0:
            x = 0.0
            y += row_h + g
            row_h = 0.0
        offsets[c] = (x, y)
        x += w + g
        row_h = max(row_h, h)
    atlas_h = y + row_h

    scale = 1.0 / max(atlas_w, atlas_h, 1e-12)
    uvs_out = []
    uv_idx = np.zeros((len(faces), 3), np.int64)
    base = 0
    for c in range(n_charts):
        uv = (chart_uvs[c] + offsets[c]) * scale
        uvs_out.append(uv)
        uv_idx[chart_fids[c]] = chart_faces[c] + base
        base += len(uv)
    return (
        np.concatenate(uvs_out, axis=0).astype(np.float32),
        uv_idx.astype(np.int32),
    )
