"""Mesh attribute ops: normals, edges, face compaction, surface sampling
(PyTorch twin of ``gshell_tpu/ops/mesh_ops.py``).  Padded faces (all three
indices equal) have zero area and contribute nothing."""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .compact import nonzero_compact
from .gather import gather_rows
from .math import dot, safe_normalize


def face_normals(v_pos, t_pos_idx, normalize: bool = True):
    v0, v1, v2 = (gather_rows(v_pos, t_pos_idx[:, k]) for k in range(3))
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    return safe_normalize(n) if normalize else n


def auto_normals(v_pos, t_pos_idx, face_mask=None):
    """Area-weighted smooth vertex normals; ``face_mask`` marks real faces."""
    fn = face_normals(v_pos, t_pos_idx, normalize=False)
    if face_mask is not None:
        fn = fn * face_mask[:, None].to(fn.dtype)
    v_nrm = torch.zeros_like(v_pos)
    for k in range(3):
        v_nrm = v_nrm + torch.zeros_like(v_pos).index_add(0, t_pos_idx[:, k], fn)
    default = torch.tensor([0.0, 0.0, 1.0], dtype=v_pos.dtype, device=v_pos.device)
    v_nrm = torch.where(dot(v_nrm, v_nrm) > 1e-20, v_nrm, default)
    return safe_normalize(v_nrm)


def compute_tangents(v_pos, v_tex, v_nrm, t_pos_idx, t_tex_idx, face_mask=None):
    """Per-vertex tangents of a UV mesh (mikktspace conventions): each face's
    tangent from its position and UV edges, averaged over the faces at a
    vertex, then orthogonalised against ``v_nrm``."""
    pos = [v_pos[t_pos_idx[:, i]] for i in range(3)]
    tex = [v_tex[t_tex_idx[:, i]] for i in range(3)]
    uve1, uve2 = tex[1] - tex[0], tex[2] - tex[0]
    pe1, pe2 = pos[1] - pos[0], pos[2] - pos[0]
    nom = pe1 * uve2[..., 1:2] - pe2 * uve1[..., 1:2]
    denom = uve1[..., 0:1] * uve2[..., 1:2] - uve1[..., 1:2] * uve2[..., 0:1]
    tang = nom / torch.where(denom > 0.0, torch.clamp(denom, min=1e-6), torch.clamp(denom, max=-1e-6))
    ones = torch.ones_like(tang)
    if face_mask is not None:
        tang = tang * face_mask[:, None].to(tang.dtype)
        ones = ones * face_mask[:, None].to(ones.dtype)
    tangents, tansum = torch.zeros_like(v_nrm), torch.zeros_like(v_nrm)
    for i in range(3):
        idx = t_pos_idx[:, i]
        tangents = tangents + torch.zeros_like(v_nrm).index_add(0, idx, tang)
        tansum = tansum + torch.zeros_like(v_nrm).index_add(0, idx, ones)
    tangents = safe_normalize(tangents / torch.clamp(tansum, min=1.0))
    return safe_normalize(tangents - dot(tangents, v_nrm) * v_nrm)


def compute_edges(t_pos_idx):
    """All (unsorted, duplicated) mesh edges, each as a sorted pair."""
    e = torch.cat([t_pos_idx[:, [0, 1]], t_pos_idx[:, [1, 2]], t_pos_idx[:, [2, 0]]], dim=0)
    return torch.sort(e, dim=1).values


def face_areas(v_pos, t_pos_idx):
    n = face_normals(v_pos, t_pos_idx, normalize=False)
    return 0.5 * torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1), min=1e-20))


def compact_faces(faces, face_valid, cap: int):
    """Gather valid faces to the front of a ``cap``-slot buffer → (faces,
    valid mask, true count)."""
    idx = nonzero_compact(face_valid, cap, 0)
    n = face_valid.sum()
    valid_c = torch.arange(cap, device=faces.device) < n
    fc = torch.where(valid_c[:, None], faces[idx], 0)
    return fc, valid_c, n


def sample_surface(draws, v_pos, t_pos_idx, n_samples: int, face_mask=None):
    """Area-weighted uniform surface samples (kaolin ``sample_points``).
    Draws ``face`` (n,) and ``uv`` (n, 2) uniforms from ``draws``."""
    areas = face_areas(v_pos, t_pos_idx)
    if face_mask is not None:
        areas = areas * face_mask.to(areas.dtype)
    cdf = torch.cumsum(areas, dim=0)
    total = torch.clamp(cdf[-1], min=1e-12)
    u = draws.uniform("face", (n_samples,)) * total
    fid = torch.clamp(torch.searchsorted(cdf, u), 0, t_pos_idx.shape[0] - 1)
    r = draws.uniform("uv", (n_samples, 2))
    su = torch.sqrt(r[:, 0:1])
    b0 = 1.0 - su
    b1 = su * (1.0 - r[:, 1:2])
    b2 = su * r[:, 1:2]
    v0, v1, v2 = (v_pos[t_pos_idx[fid, k]] for k in range(3))
    return v0 * b0 + v1 * b1 + v2 * b2


def orient_faces(faces: np.ndarray) -> np.ndarray:
    """A copy of ``faces`` (F, 3), on the host, wound consistently over each
    edge-connected component: a breadth-first walk from the component's
    first face (whose winding is kept) reverses every neighbour that runs a
    shared edge the same way.  The extractors' faces are not wound
    consistently (about half face each way, as the JAX package's); a UV
    unwrap that grows charts by signed normals needs them to be."""
    out = np.asarray(faces).tolist()
    by_edge: dict[tuple[int, int], list[int]] = {}
    for i, (a, b, c) in enumerate(out):
        for u, v in ((a, b), (b, c), (c, a)):
            by_edge.setdefault((min(u, v), max(u, v)), []).append(i)
    seen = [False] * len(out)
    for seed in range(len(out)):
        if seen[seed]:
            continue
        seen[seed] = True
        queue = deque([seed])
        while queue:
            a, b, c = out[queue.popleft()]
            for u, v in ((a, b), (b, c), (c, a)):
                for j in by_edge[(min(u, v), max(u, v))]:
                    if not seen[j]:
                        seen[j] = True
                        x, y, z = out[j]
                        if (x, y) == (u, v) or (y, z) == (u, v) or (z, x) == (u, v):
                            out[j] = [z, y, x]
                        queue.append(j)
    return np.asarray(out, dtype=np.asarray(faces).dtype).reshape(-1, 3)
