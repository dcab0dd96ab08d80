"""Materials (PyTorch twin of ``gshell_tpu/render/material.py``).

The neural PBR material: hash grid + bias-free ReLU MLP, sigmoid-squashed
into per-channel [min, max].  Its parameters are a dict ``{"tables": (L, T,
F), "mlp": [w (in, out), ...]}``; the reference's ×128 gradient hook sits
between encoder and MLP (``scale_grad``), the ÷8 on table gradients is the
trainer's.  The port's textured materials and ``.mtl`` files are not
copied."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.mlp import apply_relu_mlp
from ..ops.hashgrid import (
    HashGridConfig,
    hashgrid_encode,
    hashgrid_encode_stochastic,
)
from ..ops.math import scale_grad

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
