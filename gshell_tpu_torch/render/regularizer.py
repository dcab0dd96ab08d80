"""Shading / material / SDF regularizers (PyTorch twin of
``gshell_tpu/render/regularizer.py``, the terms the train step uses)."""
from __future__ import annotations

import torch

from ..ops.math import rgb_to_srgb


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


def _bce_with_logits(x, y):
    return torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))


def sdf_reg_loss(sdf, grid_edges):
    """SDF sign-consistency BCE over every lattice edge ``grid_edges`` (E, 2):
    the mean over the edges whose ends differ in sign (FlexiCubes path)."""
    s0, s1 = sdf[grid_edges[:, 0]], sdf[grid_edges[:, 1]]
    mask = (torch.sign(s0) != torch.sign(s1)).to(sdf.dtype)
    per_edge = _bce_with_logits(s0, (s1 > 0).to(sdf.dtype)) + _bce_with_logits(s1, (s0 > 0).to(sdf.dtype))
    return (per_edge * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sdf_reg_loss_edges(edge_sdf):
    """SDF sign-consistency BCE over the extractor's crossing-edge slots
    (V, 2); invalid slots hold (+1, +1) and mask themselves out."""
    s0, s1 = edge_sdf[:, 0], edge_sdf[:, 1]
    p0, p1 = (s0 > 0).to(edge_sdf.dtype), (s1 > 0).to(edge_sdf.dtype)
    mask = ((s0 > 0) != (s1 > 0)).to(edge_sdf.dtype)
    per_edge = _bce_with_logits(s0, p1) + _bce_with_logits(s1, p0)
    return (per_edge * mask).sum() / torch.clamp(mask.sum(), min=1.0)
