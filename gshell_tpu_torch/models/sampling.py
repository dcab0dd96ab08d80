"""Samplers for G-MeshDiffusion: DDIM (quad / uniform schedule) and PC
(ancestral predictor) over paired (feature grid, occupancy grid) states,
masked at every step, plus the predictor / corrector zoo (PyTorch twin of
``gshell_tpu/models/sampling.py``).

A sampler takes a draw source: the initial noises are ``"x"`` and
``"x_occ"``, a stochastic step ``i`` draws ``"step{i}/x"`` and
``"step{i}/x_occ"``, a corrector iteration ``j`` draws ``"noise{j}"``.
``eps_fn(x, x_occ, labels) → (eps, eps_occ)`` is the network."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .sde import VPSDE, _per_sample, ancestral_step, ddim_step


def ddim_timesteps(n_model_steps: int, n_sample_steps: int, schedule: str = "quad") -> np.ndarray:
    """Descending timestep subsequence: 'quad' or 'uniform'."""
    if schedule == "quad":
        seq = (np.linspace(0, np.sqrt(n_model_steps * 0.8), n_sample_steps) ** 2).astype(int)
    else:
        seq = np.linspace(0, n_model_steps - 1, n_sample_steps).astype(int)
    return np.unique(seq)[::-1].copy()


def _labels(shape, t: int, device) -> torch.Tensor:
    return torch.full((shape[0],), int(t), dtype=torch.int64, device=device)


def _mask(x, mask):
    return x * mask if mask is not None else x


def ddim_loop(sde: VPSDE, eps_fn: Callable, x, x_occ, seq: np.ndarray, feature_mask=None, occ_mask=None):
    """Deterministic DDIM over the descending timesteps ``seq`` (to 0)."""
    seq_prev = np.concatenate([seq[1:], [0]])
    for t, tp in zip(seq.tolist(), seq_prev.tolist()):
        eps, eps_occ = eps_fn(x, x_occ, _labels(x.shape, t, x.device))
        x = _mask(ddim_step(sde, x, eps.float(), t, tp)[0], feature_mask)
        if x_occ is not None:
            x_occ = _mask(ddim_step(sde, x_occ, eps_occ.float(), t, tp)[0], occ_mask)
    return x, x_occ


def _initial(draws, shape, occ_shape, device):
    x = draws.normal("x", shape).to(device)
    x_occ = draws.normal("x_occ", occ_shape).to(device) if occ_shape else None
    return x, x_occ


def get_ddim_sampler(sde: VPSDE, eps_fn: Callable, shape: tuple, occ_shape: Optional[tuple],
                     n_steps: int = 100, schedule: str = "quad", feature_mask=None, occ_mask=None):
    """Returns ``sampler(draws) → (x0 grid, x0 occupancy grid)``."""
    seq = ddim_timesteps(sde.N, n_steps, schedule)
    device = sde.discrete_betas.device

    @torch.no_grad()
    def sampler(draws):
        x, x_occ = _initial(draws, shape, occ_shape, device)
        return ddim_loop(sde, eps_fn, x, x_occ, seq, feature_mask, occ_mask)

    return sampler


def get_pc_sampler(sde: VPSDE, eps_fn: Callable, shape: tuple, occ_shape: Optional[tuple],
                   feature_mask=None, occ_mask=None, denoise: bool = True):
    """Ancestral (DDPM) predictor over all N steps, no corrector; with
    ``denoise`` the last step returns the mean."""
    device = sde.discrete_betas.device

    @torch.no_grad()
    def sampler(draws):
        x, x_occ = _initial(draws, shape, occ_shape, device)
        for i in range(sde.N):
            t = sde.N - 1 - i
            eps, eps_occ = eps_fn(x, x_occ, _labels(shape, t, device))
            step = draws.child(f"step{i}")
            x_new, x_mean = ancestral_step(sde, step.normal("x", x.shape).to(device), x, eps.float(), t)
            x_new = x_mean if (denoise and t == 0) else x_new
            if x_occ is not None:
                o_new, o_mean = ancestral_step(sde, step.normal("x_occ", x_occ.shape).to(device), x_occ,
                                               eps_occ.float(), t)
                x_occ = _mask(o_mean if (denoise and t == 0) else o_new, occ_mask)
            x = _mask(x_new, feature_mask)
        return x, x_occ

    return sampler


# ----------------------------------------------------------------------------
# Predictor / corrector zoo
# ----------------------------------------------------------------------------


def euler_maruyama_step(sde: VPSDE, noise, x, eps_pred, timestep: int, n_total=None):
    """Euler-Maruyama reverse-SDE predictor with the step's ``noise``."""
    dt = -1.0 / (n_total or sde.N)
    t = (timestep + 1) / sde.N
    beta_t = sde.beta_0 + t * (sde.beta_1 - sde.beta_0)
    score = -eps_pred / _per_sample(sde.sqrt_1m_alphas_cumprod, timestep, x)
    drift = -0.5 * beta_t * x - beta_t * score
    x_mean = x + drift * dt
    return x_mean + np.sqrt(beta_t) * np.sqrt(-dt) * noise, x_mean


def reverse_diffusion_step(sde: VPSDE, noise, x, eps_pred, timestep: int):
    """Reverse-diffusion (DDPM discretization) predictor."""
    beta = _per_sample(sde.discrete_betas, timestep, x)
    alpha = _per_sample(sde.alphas, timestep, x)
    score = -eps_pred / _per_sample(sde.sqrt_1m_alphas_cumprod, timestep, x)
    g = torch.sqrt(beta)
    rev_f = (torch.sqrt(alpha) * x - x) - g * g * score
    x_mean = x - rev_f
    return x_mean + g * noise, x_mean


def langevin_corrector_step(sde: VPSDE, draws, x, eps_fn_single: Callable, timestep: int,
                            snr: float = 0.075, n_steps: int = 1):
    """Langevin MCMC corrector: the step size adapts to the ratio of the
    noise's and the score's norms."""
    alpha = _per_sample(sde.alphas, timestep, x)
    a2 = _per_sample(sde.sqrt_1m_alphas_cumprod, timestep, x)
    for j in range(n_steps):
        grad = -eps_fn_single(x, timestep) / a2
        noise = draws.normal(f"noise{j}", x.shape).to(x.device)
        grad_norm = torch.sqrt(torch.mean(grad ** 2))
        noise_norm = torch.sqrt(torch.mean(noise ** 2))
        step_size = (snr * noise_norm / torch.clamp(grad_norm, min=1e-12)) ** 2 * 2 * alpha
        x = x + step_size * grad + torch.sqrt(2 * step_size) * noise
    return x


def ald_corrector_step(sde: VPSDE, draws, x, eps_fn_single: Callable, timestep: int,
                       snr: float = 0.075, n_steps: int = 1):
    """Annealed Langevin dynamics corrector: the schedule's step size
    (snr·σ_t)²·2·α_t, whatever the score's magnitude."""
    alpha = _per_sample(sde.alphas, timestep, x)
    std = _per_sample(sde.sqrt_1m_alphas_cumprod, timestep, x)
    step_size = (snr * std) ** 2 * 2 * alpha
    for j in range(n_steps):
        grad = -eps_fn_single(x, timestep) / std
        noise = draws.normal(f"noise{j}", x.shape).to(x.device)
        x = x + step_size * grad + torch.sqrt(2 * step_size) * noise
    return x


PREDICTORS = {
    "ancestral_sampling": ancestral_step,
    "euler_maruyama": euler_maruyama_step,
    "reverse_diffusion": reverse_diffusion_step,
    "none": None,
}
CORRECTORS = {"langevin": langevin_corrector_step, "ald": ald_corrector_step, "none": None}


def slerp(z0, z1, t: float):
    """Spherical interpolation between two prior noises."""
    cos = torch.sum(z0 * z1) / (torch.linalg.norm(z0) * torch.linalg.norm(z1))
    omega = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
    so = torch.sin(omega)
    return torch.sin((1.0 - t) * omega) / so * z0 + torch.sin(t * omega) / so * z1
