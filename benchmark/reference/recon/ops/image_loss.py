"""HDR image losses (PyTorch twin of ``gshell_tpu/ops/image_loss.py``)."""
from __future__ import annotations

import torch


def _tonemap_srgb(f, exposure: float = 5.0):
    f = f * exposure
    return torch.where(
        f > 0.0031308,
        torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * f,
    )


def image_loss(img, target, loss: str = "l1", tonemapper: str = "none"):
    if tonemapper == "log_srgb":
        img = _tonemap_srgb(torch.log(torch.clamp(img, 0.0, 65535.0) + 1.0))
        target = _tonemap_srgb(torch.log(torch.clamp(target, 0.0, 65535.0) + 1.0))
    if loss == "mse":
        return torch.mean((img - target) ** 2)
    if loss == "smape":
        return torch.mean(torch.abs(img - target) / (torch.abs(img) + torch.abs(target) + 0.01))
    if loss == "relmse":
        d = img - target
        return torch.mean(d * d / (img * img + target * target + 0.1))
    return torch.mean(torch.abs(img - target))


def create_loss(name: str):
    """Loss factory: smape / mse / logl1 / logl2 / relmse / l1."""
    table = {
        "smape": ("smape", "none"),
        "mse": ("mse", "none"),
        "logl1": ("l1", "log_srgb"),
        "logl2": ("mse", "log_srgb"),
        "relmse": ("relmse", "none"),
        "l1": ("l1", "none"),
    }
    loss, tm = table[name]
    return lambda img, ref: image_loss(img, ref, loss=loss, tonemapper=tm)
