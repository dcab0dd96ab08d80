"""DDPM training loss and optimizer for G-MeshDiffusion (PyTorch twin of
``gshell_tpu/models/losses.py``): ε-prediction loss with the feature-mask
and occupancy-mask weighted MSE, and AdamW with linear warmup and
global-norm clipping as optax composes them.

:class:`AdamW` is written out rather than taken from ``torch.optim``, whose
updates differ from optax's in four ways the JAX package depends on: the
warmup schedule reads optax's count, which starts at 0, so the first update
has learning rate 0; ``clip_by_global_norm`` scales by ``max_norm / norm``
with no ``+1e-6`` (``clip_grad_norm_`` adds one); weight decay is decoupled
and applies to every parameter, GroupNorm and biases included; and Adam's
bias corrections 1 − βᵗ are formed in float32."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .sde import VPSDE, _per_sample, perturb


def sample_perturbation(sde: VPSDE, draws, x, x_occ, rows: Optional[tuple] = None):
    """The loss's random draws → (labels, noise, perturbed, noise_occ,
    perturbed_occ): timestep labels ``"labels"``, standard-normal ``"noise"``
    and ``"noise_occ"``.  ``rows`` = (first row, global batch): ``x`` holds
    those rows of a global batch, and takes the same rows of the global
    batch's draws (a data-parallel rank), drawing only those
    (``Draws.rows``)."""
    first, n = rows if rows is not None else (0, x.shape[0])
    b = x.shape[0]
    labels = draws.rows("randint", "labels", (n,), first, b, 0, sde.N).to(x.device)
    noise = draws.rows("normal", "noise", (n,) + tuple(x.shape[1:]), first, b).to(x.device)
    perturbed = perturb(sde, x, labels, noise)
    noise_occ = perturbed_occ = None
    if x_occ is not None:
        noise_occ = draws.rows("normal", "noise_occ", (n,) + tuple(x_occ.shape[1:]), first, b).to(x.device)
        perturbed_occ = perturb(sde, x_occ, labels, noise_occ)
    return labels, noise, perturbed, noise_occ, perturbed_occ


def masked_score_mse(score, score_occ, noise, noise_occ, feature_mask, occ_mask, b):
    """Feature-mask + occupancy-mask weighted MSE, normalized by the masked
    site count and the batch."""
    losses = (score.float() - noise) ** 2
    fm = feature_mask if feature_mask is not None else torch.ones_like(losses[:1])
    denom = fm.sum()
    total = (losses * fm).sum()
    if score_occ is not None:
        om = occ_mask if occ_mask is not None else torch.ones_like(score_occ[:1])
        total = total + (((score_occ.float() - noise_occ) ** 2) * om).sum()
        denom = denom + om.sum()
    return total / denom / b


def ddpm_loss(sde: VPSDE, model, draws, batch: dict, feature_mask=None, occ_mask=None,
              pred_type: str = "noise", rows: Optional[tuple] = None):
    """The loss of one batch ``{"grid": (B, C, D, D, D), "occgrid": (B, 1,
    2D, 2D, 2D)}``; the model runs in whatever train / eval mode it is in.
    ``rows``: as :func:`sample_perturbation`'s (the loss normalizes by the
    local batch)."""
    x, x_occ = batch["grid"], batch.get("occgrid")
    labels, noise, perturbed, noise_occ, perturbed_occ = sample_perturbation(sde, draws, x, x_occ, rows)
    pred, pred_occ = model(perturbed, perturbed_occ, labels, feature_mask=feature_mask, occ_mask=occ_mask)
    pred = pred.float()
    if pred_type == "noise":
        score, score_occ = pred, pred_occ
    else:  # x0 prediction → ε
        a1 = _per_sample(sde.sqrt_alphas_cumprod, labels, x)
        a2 = _per_sample(sde.sqrt_1m_alphas_cumprod, labels, x)
        score = (perturbed - pred * a1) / a2
        score_occ = (perturbed_occ - pred_occ * a1) / a2 if pred_occ is not None else None
    return masked_score_mse(score, score_occ, noise, noise_occ, feature_mask, occ_mask, x.shape[0])


class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr · min(count /
    warmup, 1), b1, 0.999, eps, weight_decay))`` over a list of tensors."""

    def __init__(self, params, lr: float = 1e-5, warmup: int = 5000, grad_clip: float = 1.0,
                 weight_decay: float = 1e-5, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.warmup, self.grad_clip = lr, warmup, grad_clip
        self.weight_decay, self.beta1, self.beta2, self.eps = weight_decay, beta1, beta2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # optax's count: updates applied so far

    def learning_rate(self, count: Optional[int] = None) -> float:
        """The schedule at ``count`` (default: the next update's), in float32."""
        c = np.float32(self.count if count is None else count)
        return float(np.float32(self.lr) * np.minimum(c / np.float32(max(self.warmup, 1)), np.float32(1)))

    @torch.no_grad()
    def step(self, grads) -> float:
        """Apply one update from ``grads`` (one per parameter); returns the
        gradients' global norm before clipping."""
        grads = list(grads)
        g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        if self.grad_clip and self.grad_clip > 0 and not bool(g_norm < self.grad_clip):
            grads = [g / g_norm * self.grad_clip for g in grads]
        lr = self.learning_rate()
        self.count += 1
        bc1 = 1 - torch.tensor(self.beta1, dtype=torch.float32) ** self.count
        bc2 = 1 - torch.tensor(self.beta2, dtype=torch.float32) ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            v.mul_(self.beta2).add_(g * g, alpha=1 - self.beta2)
            u = (m / bc1.to(m.device)) / (torch.sqrt(v / bc2.to(v.device)) + self.eps)
            p.add_((u + self.weight_decay * p) * -lr)
        return float(g_norm)

    def state_dict(self) -> dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)
        self.count = int(state["count"])


def make_optimizer(params, lr: float = 1e-5, warmup: int = 5000, grad_clip: float = 1.0,
                   weight_decay: float = 1e-5, beta1: float = 0.9, eps: float = 1e-8) -> AdamW:
    """AdamW + linear warmup + gradient clipping (the JAX package's defaults)."""
    return AdamW(params, lr, warmup, grad_clip, weight_decay, beta1, 0.999, eps)
