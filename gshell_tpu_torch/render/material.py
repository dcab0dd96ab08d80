"""Materials (PyTorch twin of ``gshell_tpu/render/material.py``).

The neural PBR material: hash grid + bias-free ReLU MLP, sigmoid-squashed
into per-channel [min, max].  Its parameters are a dict ``{"tables": (L, T,
F), "mlp": [w (in, out), ...]}``; the reference's ×128 gradient hook sits
between encoder and MLP (``scale_grad``), the ÷8 on table gradients is the
trainer's.  A textured material is a :class:`TextureMaterial` of
:class:`~.texture.Texture2D` maps; ``render_mesh`` tells the two apart by
type.  ``load_mtl`` / ``save_mtl`` read and write ``.mtl`` files and
``merge_materials`` lays several materials out in one atlas."""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry.mlp import apply_relu_mlp, init_relu_mlp
from ..ops.hashgrid import (
    HashGridConfig,
    hashgrid_encode,
    hashgrid_encode_stochastic,
    init_hashgrid,
)
from ..ops.math import scale_grad, scale_img_nhwc
from ..utils.image import load_image
from .texture import Texture2D, create_trainable

GRADIENT_SCALING = 128.0


class MLPTexture3DConfig(NamedTuple):
    channels: int = 6
    internal_dims: int = 32
    hidden: int = 2
    hash: HashGridConfig = HashGridConfig()
    aabb_min: tuple = (-1.0, -1.0, -1.0)
    aabb_max: tuple = (1.0, 1.0, 1.0)
    min_max: tuple | None = None  # ((c_min,)*C, (c_max,)*C)
    # fraction of points whose table gradients are kept (training calls)
    table_grad_frac: float = 0.125


def init_mlp_texture(draws, cfg: MLPTexture3DConfig, device) -> dict:
    tables = init_hashgrid(draws.child("hashgrid"), cfg.hash, device)
    dims = [cfg.hash.out_dim] + [cfg.internal_dims] * cfg.hidden + [cfg.channels]
    return {"tables": tables, "mlp": init_relu_mlp(draws.child("mlp"), dims, device)}


def sample_mlp_texture(params: dict, cfg: MLPTexture3DConfig, pos, draws=None):
    """Material channels at world positions (…, 3) → (…, C).  With ``draws``
    (training) the table gradients come from the stochastic subset."""
    dev = pos.device
    aabb_min = torch.tensor(cfg.aabb_min, dtype=pos.dtype, device=dev)
    aabb_max = torch.tensor(cfg.aabb_max, dtype=pos.dtype, device=dev)
    shp = pos.shape[:-1]
    x = torch.clamp((pos.reshape(-1, 3) - aabb_min) / (aabb_max - aabb_min), 0.0, 1.0)
    if draws is not None and cfg.table_grad_frac < 1.0:
        feat = hashgrid_encode_stochastic(
            params["tables"], x, cfg.hash, draws.child("hashgrid"), cfg.table_grad_frac
        )
    else:
        feat = hashgrid_encode(params["tables"], x, cfg.hash)
    feat = scale_grad(feat, GRADIENT_SCALING)
    out = torch.sigmoid(apply_relu_mlp(params["mlp"], feat))
    if cfg.min_max is not None:
        lo = torch.tensor(cfg.min_max[0], dtype=out.dtype, device=dev)
        hi = torch.tensor(cfg.min_max[1], dtype=out.dtype, device=dev)
        out = out * (hi - lo) + lo
    return out.reshape(*shp, cfg.channels)


def default_kd_ks_min_max(kd_min=(0.0, 0.0, 0.0), kd_max=(1.0, 1.0, 1.0),
                          ks_min=(0.0, 0.001, 0.0), ks_max=(0.0, 1.0, 1.0)):
    """Combined 6-channel (kd | ks) range of the reference's material init."""
    return (tuple(kd_min) + tuple(ks_min), tuple(kd_max) + tuple(ks_max))


class TextureMaterial(NamedTuple):
    """Texture2D maps sampled at interpolated UVs: ``kd`` (its channel 3, if
    any, is alpha), ``ks`` (occlusion, roughness, metalness) and an optional
    tangent-space ``normal`` map."""
    kd: Texture2D
    ks: Texture2D
    normal: Optional[Texture2D] = None


def texture_material(mat: dict) -> TextureMaterial:
    """The :class:`TextureMaterial` of a material dict holding Texture2D
    under ``kd``, ``ks`` and optionally ``normal`` (``merge_materials``'s)."""
    return TextureMaterial(kd=mat["kd"], ks=mat["ks"], normal=mat.get("normal"))


def load_mtl(path: str) -> list[dict]:
    """Minimal .mtl parser: material dicts with ``name``, ``bsdf`` and
    ``kd`` / ``ks`` values or ``kd_path`` / ``ks_path`` / ``normal_path``
    (relative to the .mtl's directory)."""
    materials, mat = [], None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "newmtl":
                mat = {"name": tok[1], "bsdf": "pbr"}
                materials.append(mat)
            elif mat is None:
                continue
            elif tok[0] in ("map_Kd", "map_Ks", "bump"):
                mat[{"map_Kd": "kd_path", "map_Ks": "ks_path", "bump": "normal_path"}[tok[0]]] = \
                    os.path.join(base, tok[1])
            elif tok[0] in ("Kd", "Ks"):
                mat[tok[0].lower()] = [float(v) for v in tok[1:4]]
    return materials


def save_mtl(path: str, name: str = "defaultMat", kd=(0.8, 0.8, 0.8), ks=(0.0, 0.5, 0.0)):
    """Minimal .mtl writer of flat kd / ks values."""
    with open(path, "w") as f:
        f.write(f"newmtl {name}\nbsdf pbr\n")
        f.write(f"Kd {kd[0]} {kd[1]} {kd[2]}\n")
        f.write(f"Ks {ks[0]} {ks[1]} {ks[2]}\n")


def _material_channel(mat: dict, name: str):
    """Texels of channel ``name`` (kd / ks / normal) as a float32 (H, W, C)
    array: from ``{name}_data``, a Texture2D's base under ``{name}_tex``, an
    image at ``{name}_path`` (its first 3 channels), or a flat colour under
    ``name`` (1×1); None when the material has none of them."""
    if f"{name}_data" in mat:
        return np.asarray(mat[f"{name}_data"], np.float32)
    if f"{name}_tex" in mat and isinstance(mat[f"{name}_tex"], Texture2D):
        return mat[f"{name}_tex"].base.detach().cpu().numpy().astype(np.float32)
    if f"{name}_path" in mat:
        return np.asarray(load_image(mat[f"{name}_path"]), np.float32)[..., :3]
    if name in mat:
        return np.asarray(mat[name], np.float32).reshape(1, 1, -1)
    return None


def merge_materials(materials: list[dict], texcoords, tfaces, mfaces, device="cpu"):
    """Merge per-face materials into one atlas ("uber material"): every
    material's kd / ks / normal is resized (bilinear) to the largest
    resolution among them and the tiles are laid side by side along u in a
    power-of-two atlas, edge-replicated into the unused area; each
    (tex-vertex, material) pair becomes its own tex-vertex at
    ``u' = (material + u) · tile_w / atlas_w``, ``v' = v · tile_h / atlas_h``.

    ``texcoords`` (T, 2), ``tfaces`` (F, 3) and ``mfaces`` (F,) as
    ``load_obj(with_attrs=True)`` gives them.  → (material dict with
    Texture2D under each channel any input defines (on ``device``),
    new_texcoords (T', 2) float32, new_tfaces (F, 3) int32)."""
    assert len(materials) > 0
    bsdf = materials[0].get("bsdf", "pbr")
    assert all(m.get("bsdf", "pbr") == bsdf for m in materials), "all materials must share one BSDF"
    texcoords = np.asarray(texcoords, np.float32)
    tfaces, mfaces = np.asarray(tfaces, np.int64), np.asarray(mfaces, np.int64)
    n_mat = len(materials)
    channels = ["kd", "ks", "normal"]
    per_chan = {c: [_material_channel(m, c) for m in materials] for c in channels}
    max_res = np.array([1, 1])
    for maps in per_chan.values():
        for m in maps:
            if m is not None:
                max_res = np.maximum(max_res, m.shape[:2])
    full_res = (2 ** np.ceil(np.log2(max_res * np.array([1, n_mat])))).astype(int)

    uber = {"name": "uber_material", "bsdf": bsdf}
    defaults = {"kd": (0.8, 0.8, 0.8), "ks": (0.0, 0.5, 0.0), "normal": (0.5, 0.5, 1.0)}
    for c in channels:
        maps = per_chan[c]
        if all(m is None for m in maps):
            continue
        tiles = []
        for m in maps:
            if m is None:
                m = np.asarray(defaults[c], np.float32).reshape(1, 1, 3)
            t = scale_img_nhwc(torch.as_tensor(m)[None], (int(max_res[0]), int(max_res[1])), method="bilinear")
            tiles.append(t[0].numpy())
        row = np.concatenate(tiles, axis=1)
        pad_h, pad_w = int(full_res[0] - row.shape[0]), int(full_res[1] - row.shape[1])
        atlas = np.pad(row, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
        uber[c] = create_trainable(torch.as_tensor(atlas, device=device))

    keys = tfaces.reshape(-1) * n_mat + np.repeat(mfaces, 3)
    uniq, inverse = np.unique(keys, return_inverse=True)
    new_tfaces = inverse.reshape(-1, 3).astype(np.int32)
    src_ti, src_mi = uniq // n_mat, uniq % n_mat
    s_v, s_u = max_res[0] / full_res[0], max_res[1] / full_res[1]
    new_texcoords = np.stack([(src_mi + texcoords[src_ti, 0]) * s_u, texcoords[src_ti, 1] * s_v],
                             axis=-1).astype(np.float32)
    return uber, new_texcoords, new_tfaces
