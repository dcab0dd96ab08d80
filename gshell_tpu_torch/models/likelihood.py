"""Probability-flow ODE log-likelihood (PyTorch twin of
``gshell_tpu/models/likelihood.py``): fixed-step RK4 with the
Hutchinson–Skilling divergence estimator, whose vector–Jacobian product
comes from ``torch.autograd.grad``."""
from __future__ import annotations

import math
from typing import Callable

import torch

from .sde import VPSDE


def _drift(sde: VPSDE, score_fn: Callable, x, t: float):
    """Probability-flow drift f(x, t) − ½ g(t)² ∇log p (VPSDE)."""
    beta_t = sde.beta_0 + t * (sde.beta_1 - sde.beta_0)
    return -0.5 * beta_t * (x + score_fn(x, t))


def ode_log_likelihood(sde: VPSDE, score_fn: Callable, x, draws, n_steps: int = 100, t0: float = 1e-3):
    """``score_fn(x, t) → ∇log p_t(x)``; the Rademacher probe is
    ``2·draws.randint("rademacher", x.shape, 0, 2) − 1`` → (log p(x)
    estimate, prior z)."""
    eps_v = (draws.randint("rademacher", x.shape, 0, 2) * 2 - 1).to(device=x.device, dtype=x.dtype)
    dt = (1.0 - t0) / n_steps

    def dynamics(xt, t):
        with torch.enable_grad():
            xt = xt.detach().requires_grad_(True)
            drift = _drift(sde, score_fn, xt, t)
            (eps_grad,) = torch.autograd.grad(drift, xt, grad_outputs=eps_v)
        return drift.detach(), torch.sum(eps_grad * eps_v)

    xt, logp = x, torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(n_steps):
        t = t0 + i * dt
        k1, d1 = dynamics(xt, t)
        k2, d2 = dynamics(xt + 0.5 * dt * k1, t + 0.5 * dt)
        k3, d3 = dynamics(xt + 0.5 * dt * k2, t + 0.5 * dt)
        k4, d4 = dynamics(xt + dt * k3, t + dt)
        xt = xt + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        logp = logp + dt / 6.0 * (d1 + 2 * d2 + 2 * d3 + d4)
    n = xt.numel()
    prior_logp = -0.5 * n * math.log(2 * math.pi) - 0.5 * torch.sum(xt ** 2)
    return prior_logp + logp, xt
