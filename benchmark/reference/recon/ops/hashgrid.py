"""Multiresolution hash-grid encoding (instant-NGP style), PyTorch twin of
``gshell_tpu/ops/hashgrid.py``.

Tables are (L, T, F); outputs are feature-major [f·L + l], the JAX order.
Corner indices, weights and weight derivatives are computed as (P, 8L)
arrays, column l·8 + c with corner bits c = cx·4 + cy·2 + cz.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Spatial-hash primes (instant-ngp); the last two as wrapped int32.
_PRIMES = (1, 2654435761, 805459861)
_P1 = int(np.uint32(_PRIMES[1]).astype(np.int32))
_P2 = int(np.uint32(_PRIMES[2]).astype(np.int32))


class HashGridConfig(NamedTuple):
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    desired_resolution: int = 4096
    # The exact forward reads the tables rounded to fp16 (tiny-cuda-nn's
    # table precision); False reads them in f32.
    packed_fp16: bool = True

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def per_level_scale(self) -> float:
        return math.exp(
            math.log(self.desired_resolution / self.base_resolution) / (self.n_levels - 1)
        )

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_resolutions(self):
        s = self.per_level_scale
        return [int(math.floor(self.base_resolution * (s**l))) for l in range(self.n_levels)]


def _corner_weight_arrays(x, cfg: HashGridConfig, with_jac: bool):
    """(idx (P, 8L) int64 into the flattened (L·T) table, wgt (P, 8L),
    [dwx, dwy, dwz (P, 8L)])."""
    T, L = cfg.table_size, cfg.n_levels
    dev = x.device
    lvl = np.repeat(np.arange(L), 8)
    cx = np.tile(np.array([0, 0, 0, 0, 1, 1, 1, 1]), L)
    cy = np.tile(np.array([0, 0, 1, 1, 0, 0, 1, 1]), L)
    cz = np.tile(np.array([0, 1, 0, 1, 0, 1, 0, 1]), L)
    res_np = np.asarray(cfg.level_resolutions())[lvl]
    dense_np = (res_np + 1) ** 3 <= T
    col = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)[None, :]
    res_col = col(res_np.astype(np.float32), x.dtype)
    res_i_col = col(res_np, torch.int32)
    res_d_col = col(np.where(dense_np, res_np + 1, 1), torch.int32)
    dense_col = col(dense_np, torch.bool)
    off_col = col(lvl * T, torch.int64)

    def axis(xd, cb):
        cbt = col(cb, torch.int32)
        xs = xd[:, None] * res_col
        x0 = torch.minimum(torch.clamp(torch.floor(xs), min=0).to(torch.int32), res_i_col - 1)
        t = xs - x0.to(xs.dtype)
        return x0 + cbt, torch.where(cbt == 1, t, 1.0 - t)

    ix, fx = axis(x[:, 0], cx)
    iy, fy = axis(x[:, 1], cy)
    iz, fz = axis(x[:, 2], cz)
    idx_dense = (ix * res_d_col + iy) * res_d_col + iz
    h = (ix * _PRIMES[0]) ^ (iy * _P1) ^ (iz * _P2)  # int32, wraps like the TPU
    idx_hash = torch.remainder(torch.abs(h), T)
    idx = torch.where(dense_col, idx_dense, idx_hash).long() + off_col
    wgt = fx * fy * fz
    if not with_jac:
        return idx, wgt, None
    s = lambda cb: torch.where(col(cb, torch.int32) == 1, res_col, -res_col)
    return idx, wgt, (s(cx) * fy * fz, fx * s(cy) * fz, fx * fy * s(cz))


def hashgrid_encode(tables, x, cfg: HashGridConfig):
    """Exact encode of x ∈ [0,1]^(…,3) → (…, L·F), gradients to tables and x."""
    shp = x.shape[:-1]
    x = torch.clamp(x.reshape(-1, 3), 0.0, 1.0)
    p, L = x.shape[0], cfg.n_levels
    idx, wgt, _ = _corner_weight_arrays(x, cfg, with_jac=False)
    outs = [
        (tables[..., f].reshape(-1)[idx] * wgt).reshape(p, L, 8).sum(dim=2)
        for f in range(tables.shape[-1])
    ]
    return torch.cat(outs, dim=1).reshape(*shp, cfg.out_dim)


class HashgridEncodeXGrads(torch.autograd.Function):
    """Exact-forward encode whose gradient flows ONLY to ``x`` (tables are
    constants).  The forward contracts the trilinear weight derivatives with
    the gathered features and saves that position Jacobian, so the backward
    is elementwise (JAX ``hashgrid_encode_x_grads`` :247)."""

    @staticmethod
    def forward(ctx, tables, x, cfg):
        p, L = x.shape[0], cfg.n_levels
        idx, wgt, (dwx, dwy, dwz) = _corner_weight_arrays(x, cfg, with_jac=True)
        t = tables.detach()
        if t.shape[-1] == 2 and cfg.packed_fp16:
            t = t.half().float()  # the TPU's packed fp16 table read
        outs, jac = [], [[], [], []]
        for f in range(t.shape[-1]):
            feats = t[..., f].reshape(-1)[idx]
            red = lambda w_: (feats * w_).reshape(p, L, 8).sum(dim=2)
            outs.append(red(wgt))
            for d, dw in enumerate((dwx, dwy, dwz)):
                jac[d].append(red(dw))
        ctx.save_for_backward(torch.cat(jac[0] + jac[1] + jac[2], dim=1))
        ctx.k = cfg.out_dim
        return torch.cat(outs, dim=1)

    @staticmethod
    def backward(ctx, g):
        (jac,) = ctx.saved_tensors
        k = ctx.k
        dx = torch.stack([(g * jac[:, d * k:(d + 1) * k]).sum(dim=1) for d in range(3)], dim=-1)
        return None, dx, None


def hashgrid_encode_stochastic(tables, x, cfg: HashGridConfig, draws, frac: float):
    """Exact forward; x-gradients exact; table gradients from a random
    subset ``sel`` of the points (drawn as ``sel``), scaled 1/frac — an
    unbiased estimator (JAX ``hashgrid_encode_stochastic`` :297)."""
    shp = x.shape[:-1]
    xf = x.reshape(-1, 3)
    p = xf.shape[0]
    full = HashgridEncodeXGrads.apply(tables, xf, cfg)
    n_sub = max(int(p * frac), 1)
    sel = draws.randint("sel", (n_sub,), 0, p).to(xf.device)
    sub = hashgrid_encode(tables, xf[sel].detach(), cfg)
    delta = (sub - sub.detach()) * (p / n_sub)  # zero in value
    return full.index_add(0, sel, delta).reshape(*shp, cfg.out_dim)
