"""Variance-preserving SDE (DDPM) with the paired (grid, occ-grid) DDIM and
ancestral updates (PyTorch twin of ``gshell_tpu/models/sde.py``).

The tables are built in float32 as the JAX package builds them:
``linspace`` as ``start·(1 − i/(n−1)) + stop·i/(n−1)`` and a ``cumprod``.
XLA fuses the products and orders the ``cumprod`` its own way, so they agree
with JAX's to a few ulp (``tests/test_torch_diffusion.py``: 2e-6 relative,
√(1 − ᾱ) 2e-6 absolute)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class VPSDE(NamedTuple):
    beta_0: float
    beta_1: float
    N: int
    discrete_betas: torch.Tensor  # (N,)
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_1m_alphas_cumprod: torch.Tensor

    @property
    def T(self) -> float:
        return 1.0

    def to(self, device) -> "VPSDE":
        return self._replace(**{k: v.to(device) for k, v in self._asdict().items()
                                if isinstance(v, torch.Tensor)})


def make_vpsde(beta_min: float = 0.1, beta_max: float = 20.0, n: int = 1000, device="cpu") -> VPSDE:
    lo = torch.tensor(beta_min / n, dtype=torch.float32)
    hi = torch.tensor(beta_max / n, dtype=torch.float32)
    step = torch.arange(n - 1, dtype=torch.float32) / (n - 1)
    betas = torch.cat([lo * (1 - step) + hi * step, hi[None]])
    alphas = 1.0 - betas
    acp = torch.cumprod(alphas, 0)
    return VPSDE(beta_0=beta_min, beta_1=beta_max, N=n, discrete_betas=betas, alphas=alphas,
                 alphas_cumprod=acp, sqrt_alphas_cumprod=torch.sqrt(acp),
                 sqrt_1m_alphas_cumprod=torch.sqrt(1.0 - acp)).to(device)


def _per_sample(table: torch.Tensor, t, x: torch.Tensor) -> torch.Tensor:
    """``table[t]`` shaped to broadcast over ``x``'s non-batch axes; ``t`` is
    an int, a 0-d or a (B,) tensor."""
    v = table[torch.as_tensor(t, device=table.device)]
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


def perturb(sde: VPSDE, x, labels, noise):
    """q(x_t | x_0) with integer timestep labels."""
    return _per_sample(sde.sqrt_alphas_cumprod, labels, x) * x + \
        _per_sample(sde.sqrt_1m_alphas_cumprod, labels, x) * noise


def ddim_step(sde: VPSDE, x, eps_pred, timestep, timestep_prev):
    """Deterministic DDIM update (η = 0) → (x_prev, x0_pred)."""
    a1 = _per_sample(sde.sqrt_alphas_cumprod, timestep, x)
    a2 = _per_sample(sde.sqrt_1m_alphas_cumprod, timestep, x)
    r1 = _per_sample(sde.sqrt_alphas_cumprod, timestep_prev, x) / a1
    r2 = _per_sample(sde.sqrt_1m_alphas_cumprod, timestep_prev, x) / a2
    x0_pred_scaled = x - a2 * eps_pred
    score_scaled_t = x - x0_pred_scaled
    return r1 * x + (-r1 + r2) * score_scaled_t, x0_pred_scaled / a1


def ancestral_step(sde: VPSDE, noise, x, eps_pred, timestep):
    """DDPM ancestral update with the step's standard-normal ``noise`` →
    (x_new, x_mean)."""
    beta = _per_sample(sde.discrete_betas, timestep, x)
    score = -eps_pred / _per_sample(sde.sqrt_1m_alphas_cumprod, timestep, x)
    x_mean = (x + beta * score) / torch.sqrt(1.0 - beta)
    return x_mean + torch.sqrt(beta) * noise, x_mean
