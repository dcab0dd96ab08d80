"""Mesh attribute ops: normals, edges, face compaction, surface sampling
(PyTorch twin of ``gshell_tpu/ops/mesh_ops.py``).  Padded faces (all three
indices equal) have zero area and contribute nothing."""
from __future__ import annotations

import torch

from .compact import nonzero_compact
from .math import dot, safe_normalize


def face_normals(v_pos, t_pos_idx, normalize: bool = True):
    v0, v1, v2 = (v_pos[t_pos_idx[:, k]] for k in range(3))
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
