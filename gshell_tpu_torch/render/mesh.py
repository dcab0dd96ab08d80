"""Mesh container and OBJ IO (PyTorch twin of ``gshell_tpu/render/mesh.py``).

``Mesh`` holds torch tensors; ``face_valid`` marks real faces of a padded
face buffer (None = all valid)."""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.mesh_ops import auto_normals


class Mesh(NamedTuple):
    v_pos: torch.Tensor  # (V, 3)
    t_pos_idx: torch.Tensor  # (F, 3) int64
    v_nrm: Optional[torch.Tensor] = None
    v_tex: Optional[torch.Tensor] = None
    v_tng: Optional[torch.Tensor] = None
    face_valid: Optional[torch.Tensor] = None  # (F,) bool

    def with_normals(self) -> "Mesh":
        return self._replace(v_nrm=auto_normals(self.v_pos, self.t_pos_idx, self.face_valid))

    def aabb(self):
        return self.v_pos.min(dim=0).values, self.v_pos.max(dim=0).values


def unit_size(mesh: Mesh) -> Mesh:
    """Center and scale to fit in [-0.5, 0.5]³."""
    vmin, vmax = mesh.aabb()
    center = (vmin + vmax) / 2
    scale = 1.0 / torch.max(vmax - vmin)
    return mesh._replace(v_pos=(mesh.v_pos - center) * scale)


def load_obj(path: str, scale: float = 1.0, with_attrs: bool = False, device="cpu"):
    """OBJ loader: positions and faces (fans triangulated), with smooth
    normals; with ``with_attrs`` also the texcoord / normal face indices,
    per-face material indices and names, and the mtllib."""
    verts, texs, nrms, faces, tfaces, nfaces = [], [], [], [], [], []
    mfaces, mat_names, mtllib = [], [], None
    cur_mat = -1
    with open(path, "r") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                texs.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "vn":
                nrms.append([float(x) for x in tok[1:4]])
            elif tok[0] == "mtllib":
                mtllib = tok[1]
            elif tok[0] == "usemtl":
                if tok[1] not in mat_names:
                    mat_names.append(tok[1])
                cur_mat = mat_names.index(tok[1])
            elif tok[0] == "f":
                parts = [t.split("/") for t in tok[1:]]
                vi = [int(p[0]) - 1 for p in parts]
                ti = [int(p[1]) - 1 if len(p) > 1 and p[1] else -1 for p in parts]
                ni = [int(p[2]) - 1 if len(p) > 2 and p[2] else -1 for p in parts]
                for k in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[k], vi[k + 1]])
                    tfaces.append([ti[0], ti[k], ti[k + 1]])
                    nfaces.append([ni[0], ni[k], ni[k + 1]])
                    mfaces.append(max(cur_mat, 0))
    v = torch.as_tensor(np.asarray(verts, np.float32) * scale, device=device)
    f = torch.as_tensor(np.asarray(faces, np.int64).reshape(-1, 3), device=device)
    mesh = Mesh(v_pos=v, t_pos_idx=f).with_normals()
    if texs:
        mesh = mesh._replace(v_tex=torch.as_tensor(np.asarray(texs, np.float32), device=device))
    if not with_attrs:
        return mesh
    return mesh, {
        "t_tex_idx": np.asarray(tfaces, np.int32),
        "t_nrm_idx": np.asarray(nfaces, np.int32),
        "v_nrm_file": np.asarray(nrms, np.float32) if nrms else None,
        "m_face_idx": np.asarray(mfaces, np.int32),
        "mat_names": mat_names,
        "mtllib": mtllib,
    }


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_obj(path: str, v_pos, faces, face_valid=None, uvs=None, uv_idx=None, mtl_name: str | None = None) -> int:
    """OBJ writer: drops padded faces (``face_valid`` False), degenerate faces
    (two equal indices) and unreferenced vertices.  ``uvs`` / ``uv_idx``
    (parallel to ``faces``) add ``vt`` rows and ``f v/vt`` faces, ``v``
    unflipped; ``mtl_name`` adds ``mtllib`` / ``usemtl``.  Writes the JAX
    package's bytes for the same inputs.  Returns the face count."""
    v, f = _np(v_pos), _np(faces)
    fuv = None if uv_idx is None else _np(uv_idx)
    if face_valid is not None:
        sel = _np(face_valid).astype(bool)
        f, fuv = f[sel], None if fuv is None else fuv[sel]
    keep = ~((f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 0] == f[:, 2]))
    f, fuv = f[keep], None if fuv is None else fuv[keep]
    used = np.unique(f.reshape(-1))
    remap = np.full(v.shape[0], -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    v, f = v[used], remap[f]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as out:
        if mtl_name is not None:
            out.write(f"mtllib {mtl_name}.mtl\nusemtl {mtl_name}\n")
        out.write("".join(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n" for p in v))
        if fuv is None:
            out.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
        else:
            out.write("".join(f"vt {t[0]:.6f} {t[1]:.6f}\n" for t in _np(uvs)))
            out.write("".join(f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {c + 1}/{tc + 1}\n"
                              for (a, b, c), (ta, tb, tc) in zip(f, fuv)))
    return int(f.shape[0])
