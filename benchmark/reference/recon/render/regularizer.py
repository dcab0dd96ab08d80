"""Shading / material / geometry / SDF regularizers and the second-layer
and depth losses (PyTorch twin of ``gshell_tpu/render/regularizer.py``).
``image_grad``, ``avg_edge_length``, ``laplace_regularizer_const`` and
``normal_consistency`` are library functions no entry point calls, as in
the JAX package."""
from __future__ import annotations

import torch

from ..geometry.tet_grid import EDGE_OFFSETS
from ..ops.math import rgb_to_srgb
from ..ops.mesh_ops import compute_edges, face_normals


def _luma(x):
    return ((x[..., 0:1] + x[..., 1:2] + x[..., 2:3]) / 3.0).expand(*x.shape[:-1], 3)


def _value(x):
    return torch.amax(x[..., 0:3], dim=-1, keepdim=True).expand(*x.shape[:-1], 3)


def chroma_loss(kd, color_ref, lambda_chroma):
    eps = 0.001
    ref_chroma = color_ref[..., 0:3] / torch.clamp(_value(color_ref), min=eps)
    opt_chroma = kd[..., 0:3] / torch.clamp(_value(kd), min=eps)
    return torch.mean(torch.abs((opt_chroma - ref_chroma) * color_ref[..., 3:])) * lambda_chroma


def shading_loss(diffuse_light, specular_light, color_ref, lambda_diffuse, lambda_specular):
    """Monochrome-diffuse + specular-ratio regularizer."""
    diffuse_luma = _luma(diffuse_light)
    specular_luma = _luma(specular_light)
    ref_luma = _value(color_ref)
    eps = 0.001
    img = rgb_to_srgb(torch.log(
        torch.clamp((diffuse_luma + specular_luma) * color_ref[..., 3:], 0.0, 65535.0) + 1.0))
    target = rgb_to_srgb(torch.log(torch.clamp(ref_luma * color_ref[..., 3:], 0.0, 65535.0) + 1.0))
    loss = torch.mean(torch.abs(img - target)) * lambda_diffuse
    loss = loss + (
        torch.mean(specular_luma) / torch.clamp(torch.mean(diffuse_luma), min=eps) * lambda_specular
    )
    return loss


def material_smoothness_grad(kd_grad, ks_grad, nrm_grad, lambda_kd=0.25, lambda_ks=0.1, lambda_nrm=0.0):
    kd_luma_grad = (kd_grad[..., 0] + kd_grad[..., 1] + kd_grad[..., 2]) / 3.0
    loss = torch.mean(kd_luma_grad * kd_grad[..., -1]) * lambda_kd
    loss = loss + torch.mean(ks_grad[..., :-1] * ks_grad[..., -1:]) * lambda_ks
    loss = loss + torch.mean(nrm_grad[..., :-1] * nrm_grad[..., -1:]) * lambda_nrm
    return loss


def image_grad(draws, buf, std: float = 0.01):
    """Stochastic image-gradient magnitude for kd/ks smoothness: |Δ| against
    the image rolled by an integer shift of up to ⌈std·H⌉ pixels (draw
    ``shift`` (2,)), weighted by both taps' last channel."""
    h = buf.shape[-3]
    shift_px = max(int(round(std * h)), 1)
    s = draws.randint("shift", (2,), -shift_px, shift_px + 1)
    tap = torch.roll(buf, (int(s[0]), int(s[1])), dims=(-3, -2))
    return torch.abs(tap[..., :-1] - buf[..., :-1]) * tap[..., -1:] * buf[..., -1:]


def avg_edge_length(v_pos, t_pos_idx):
    e = compute_edges(t_pos_idx)
    d = v_pos[e[:, 0]] - v_pos[e[:, 1]]
    return torch.mean(torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=1e-20)))


def laplace_regularizer_const(v_pos, t_pos_idx, face_mask=None):
    """Mean square of the umbrella-operator Laplacian; faces outside
    ``face_mask`` count for nothing."""
    num_v = v_pos.shape[0]
    v = [v_pos[t_pos_idx[:, k]] for k in range(3)]
    m = (torch.ones((t_pos_idx.shape[0], 1), dtype=v_pos.dtype, device=v_pos.device) if face_mask is None
         else face_mask[:, None].to(v_pos.dtype))
    term = torch.zeros_like(v_pos)
    norm = torch.zeros((num_v, 1), dtype=v_pos.dtype, device=v_pos.device)
    for k in range(3):
        a, b = v[(k + 1) % 3], v[(k + 2) % 3]
        term = term.index_add(0, t_pos_idx[:, k], ((a - v[k]) + (b - v[k])) * m)
        norm = norm.index_add(0, t_pos_idx[:, k], 2.0 * m)
    return torch.mean((term / torch.clamp(norm, min=1.0)) ** 2)


def normal_consistency(v_pos, t_pos_idx, face_mask=None):
    """Dihedral smoothness: the mean of (1 − ⟨n₀, n₁⟩)/2 over pairs of faces
    that share an edge, found as neighbours in the faces' edges sorted by
    their vertex pair (faces outside ``face_mask`` have a zero normal)."""
    fn = face_normals(v_pos, t_pos_idx)
    if face_mask is not None:
        fn = fn * face_mask[:, None].to(fn.dtype)
    f = t_pos_idx
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], dim=0)
    key = torch.minimum(e[:, 0], e[:, 1]) * v_pos.shape[0] + torch.maximum(e[:, 0], e[:, 1])
    order = torch.argsort(key, stable=True)
    fidx = torch.arange(f.shape[0], device=f.device).repeat(3)[order]
    key_s = key[order]
    same = (key_s[1:] == key_s[:-1]).to(fn.dtype)
    d = torch.clamp(torch.sum(fn[fidx[:-1]] * fn[fidx[1:]], -1), -1.0, 1.0)
    return ((1.0 - d) * 0.5 * same).sum() / torch.clamp(same.sum(), min=1.0)


def _bce_with_logits(x, y):
    return torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))


def sdf_reg_loss(sdf, grid_edges):
    """SDF sign-consistency BCE over every lattice edge ``grid_edges`` (E, 2):
    the mean over the edges whose ends differ in sign (FlexiCubes path)."""
    s0, s1 = sdf[grid_edges[:, 0]], sdf[grid_edges[:, 1]]
    mask = (torch.sign(s0) != torch.sign(s1)).to(sdf.dtype)
    per_edge = _bce_with_logits(s0, (s1 > 0).to(sdf.dtype)) + _bce_with_logits(s1, (s0 > 0).to(sdf.dtype))
    return (per_edge * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sdf_reg_loss_lattice(sdf_vol):
    """:func:`sdf_reg_loss` over every edge of the Freudenthal lattice, by
    shifted slices of the (n, n, n) volume: the mean over the edges whose
    ends differ in occupancy (s > 0), the edge set the extractor crosses."""
    num = cnt = 0.0
    n = sdf_vol.shape[0]
    for ox, oy, oz in EDGE_OFFSETS.tolist():
        s0, s1 = sdf_vol[:n - ox, :n - oy, :n - oz], sdf_vol[ox:, oy:, oz:]
        mask = ((s0 > 0) != (s1 > 0)).to(sdf_vol.dtype)
        per_edge = (_bce_with_logits(s0, (s1 > 0).to(sdf_vol.dtype))
                    + _bce_with_logits(s1, (s0 > 0).to(sdf_vol.dtype)))
        num = num + (per_edge * mask).sum()
        cnt = cnt + mask.sum()
    return num / torch.clamp(torch.as_tensor(cnt, dtype=sdf_vol.dtype), min=1.0)


def sdf_reg_loss_edges(edge_sdf):
    """SDF sign-consistency BCE over the extractor's crossing-edge slots
    (V, 2); invalid slots hold (+1, +1) and mask themselves out."""
    s0, s1 = edge_sdf[:, 0], edge_sdf[:, 1]
    p0, p1 = (s0 > 0).to(edge_sdf.dtype), (s1 > 0).to(edge_sdf.dtype)
    mask = ((s0 > 0) != (s1 > 0)).to(edge_sdf.dtype)
    per_edge = _bce_with_logits(s0, p1) + _bce_with_logits(s1, p0)
    return (per_edge * mask).sum() / torch.clamp(mask.sum(), min=1.0)

