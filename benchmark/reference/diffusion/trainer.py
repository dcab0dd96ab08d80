"""The plain reference of one G-MeshDiffusion update.

A frozen copy of the port's ``DiffusionTrainer.train_step`` on one process
(``train/diffusion.py`` at the commit the benchmark was written against):
``num_grad_acc_steps`` micro-batches through the DDPM loss and its
backward, the gradients averaged, clipped AdamW with warm-up, then the EMA.
The U-Net, the SDE, the loss, AdamW and the EMA are the copies beside it.
It computes under the precision the configuration states (``bfloat16``
autocast, float32 parameters, optimizer and EMA); ``fp8`` rounds every
convolution's and dense layer's operands to float8 first, the control;
``channels_last`` runs the convolutions in that layout, a sound change of
rounding order (a reading, not a control).  It imports nothing of the
port."""
from __future__ import annotations

import contextlib

import torch

from .ema import EMA
from .losses import ddpm_loss, make_optimizer
from .sde import make_vpsde
from .unet3d import UNet3D, UNet3DConfig, compute_policy, convolutions_channels_last, operands_in_fp8


def unet_config(cfg: dict) -> UNet3DConfig:
    return UNet3DConfig(data_ch=cfg["data_ch"], base_channels=cfg["base_channels"], ch_mult=tuple(cfg["ch_mult"]),
                        num_res_blocks=cfg["num_res_blocks"], dropout=cfg["dropout"], use_occ=cfg["use_occ_grid"],
                        remat=cfg["remat"], compute_dtype=cfg["compute_dtype"])


class ReferenceDiffusion:
    def __init__(self, cfg: dict, weights: dict, device, start_count: int, fp8: bool = False,
                 channels_last: bool = False):
        """``weights``: {parameter name: tensor}, the state the program started
        from; AdamW and the EMA start at ``start_count`` updates."""
        self.cfg, self.device, self.fp8, self.channels_last = cfg, torch.device(device), fp8, channels_last
        with self.device:
            self.model = UNet3D(unet_config(cfg))
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(weights[name])
        self.params = list(self.model.parameters())
        self.opt = make_optimizer(self.params, cfg["lr"], cfg["warmup"], cfg["grad_clip"], cfg["weight_decay"])
        self.opt.count = start_count
        self.ema = EMA(self.params)
        self.ema.num_updates = start_count
        self.sde = make_vpsde(cfg["beta_min"], cfg["beta_max"], cfg["num_scales"], device=self.device)

    def train_step(self, draws, batch: dict) -> float:
        """One update from ``batch`` {"grid": (A, 1, C, D, D, D), "occgrid":
        (A, 1, 1, 2D, 2D, 2D)} → the mean loss of its micro-batches."""
        a = self.cfg["num_grad_acc_steps"]
        model = self.model
        model.train()
        for p in self.params:
            p.grad = None
        seed = int(draws.randint("dropout_seed", (1,), 0, 2 ** 62)[0])
        loss_sum = torch.zeros((), device=self.device)
        devices = [self.device] if self.device.type == "cuda" else []
        low = operands_in_fp8() if self.fp8 else contextlib.nullcontext()
        layout = convolutions_channels_last() if self.channels_last else contextlib.nullcontext()
        with torch.random.fork_rng(devices=devices, device_type=self.device.type), low, layout:
            torch.manual_seed(seed)
            for i in range(a):
                mb = {k: v[i] for k, v in batch.items()}
                with compute_policy(self.cfg["compute_dtype"], self.device.type):
                    loss = ddpm_loss(self.sde, model, draws.child(f"micro{i}"), mb, None, None, rows=(0, 1))
                    loss.backward()
                loss_sum += loss.detach()
        grads = [p.grad.div_(a) for p in self.params]
        self.opt.step(grads)
        self.ema.update(self.params, self.cfg["ema_rate"])
        return float(loss_sum) / a
