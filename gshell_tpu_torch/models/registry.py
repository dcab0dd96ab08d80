"""Score-model registry and the score-function adapter (PyTorch twin of
``gshell_tpu/models/registry.py``): models by name, and ``get_score_fn``,
which turns an ε-prediction (or x0-prediction) network into the score
∇log p_t(x) = −ε / σ_t."""
from __future__ import annotations

from typing import Callable

from .sde import _per_sample
from .unet3d import UNet3D

_MODELS: dict[str, Callable] = {}


def register_model(cls=None, *, name: str | None = None):
    def wrap(c):
        _MODELS[name or c.__name__] = c
        return c

    return wrap(cls) if cls is not None else wrap


def get_model(name: str):
    return _MODELS[name]


def create_model(name: str, *args, **kwargs):
    return _MODELS[name](*args, **kwargs)


def get_score_fn(sde, model_fn: Callable, pred_type: str = "noise"):
    """``model_fn(x, x_occ, labels, **kw) → (pred, pred_occ)`` →
    ``score_fn(x, x_occ, labels, **kw) → (score, score_occ)``."""

    def score_fn(x, x_occ, labels, **kw):
        pred, pred_occ = model_fn(x, x_occ, labels, **kw)
        std = _per_sample(sde.sqrt_1m_alphas_cumprod, labels, x)
        if pred_type == "noise":
            return -pred / std, (-pred_occ / std if pred_occ is not None else None)
        a1 = _per_sample(sde.sqrt_alphas_cumprod, labels, x)
        score = -(x - pred * a1) / (std * std)
        score_occ = -(x_occ - pred_occ * a1) / (std * std) if pred_occ is not None else None
        return score, score_occ

    return score_fn


register_model(UNet3D, name="unet3d_occgrid")
