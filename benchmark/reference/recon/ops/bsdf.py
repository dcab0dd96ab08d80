"""Physically based BSDF pieces (PyTorch twin of ``gshell_tpu/ops/bsdf.py``)."""
from __future__ import annotations

import math

import torch

from .math import dot, safe_normalize

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


def bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading: bool = True):
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + (smooth_nrm - geom_nrm) * t


def perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl: bool = True):
    smooth_bitang = safe_normalize(torch.linalg.cross(smooth_tng, smooth_nrm))
    sign = -1.0 if opengl else 1.0
    shading_nrm = (
        smooth_tng * perturbed_nrm[..., 0:1]
        + sign * smooth_bitang * perturbed_nrm[..., 1:2]
        + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0)
    )
    return safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm, smooth_tng,
                           geom_nrm, two_sided_shading: bool = True, opengl: bool = True):
    smooth_nrm = safe_normalize(smooth_nrm)
    view_vec = safe_normalize(view_pos - pos)
    if perturbed_nrm is not None:
        smooth_tng = safe_normalize(smooth_tng)
        shading_nrm = perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl)
    else:
        shading_nrm = smooth_nrm
    return bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)


def lambert(nrm, wi):
    return torch.clamp(dot(nrm, wi), min=0.0) / math.pi


def fresnel_schlick(f0, f90, cos_theta):
    ct = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - ct) ** 5.0


def ndf_ggx(alpha_sqr, cos_theta):
    ct = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (ct * alpha_sqr - ct) * ct + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    ct = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    ct2 = ct * ct
    tan2 = (1.0 - ct2) / ct2
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan2) - 1.0)


def masking_smith_ggx_correlated(alpha_sqr, cos_theta_i, cos_theta_o):
    li = lambda_ggx(alpha_sqr, cos_theta_i)
    lo = lambda_ggx(alpha_sqr, cos_theta_o)
    return 1.0 / (1.0 + li + lo)


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness: float = 0.08):
    _alpha = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = _alpha * _alpha
    h = safe_normalize(wo + wi)
    wo_dot_n = dot(wo, nrm)
    wi_dot_n = dot(wi, nrm)
    wo_dot_h = dot(wo, h)
    n_dot_h = dot(nrm, h)
    d = ndf_ggx(alpha_sqr, n_dot_h)
    g = masking_smith_ggx_correlated(alpha_sqr, wo_dot_n, wi_dot_n)
    f = fresnel_schlick(col, 1.0, wo_dot_h)
    w = f * d * g * 0.25 / torch.clamp(wo_dot_n, min=SPECULAR_EPSILON)
    frontfacing = (wo_dot_n > SPECULAR_EPSILON) & (wi_dot_n > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, 0.0)
