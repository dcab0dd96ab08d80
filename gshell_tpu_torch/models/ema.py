"""Exponential moving average of parameters (PyTorch twin of
``gshell_tpu/models/ema.py``) with the reference's ``min(decay, (1 + n) /
(10 + n))`` warmup.  The shadow copy is always float32: a bf16 shadow
rounds the increments away at decay 0.9999 (ROADMAP C)."""
from __future__ import annotations

import numpy as np
import torch


class EMA:
    def __init__(self, params):
        self.params = [p.detach().float().clone() for p in params]
        self.num_updates = 0

    @torch.no_grad()
    def update(self, new_params, decay: float = 0.9999) -> None:
        self.num_updates += 1
        n = np.float32(self.num_updates)
        d = np.minimum(np.float32(decay), (np.float32(1) + n) / (np.float32(10) + n))
        one_minus_d = float(np.float32(1) - d)
        for e, p in zip(self.params, new_params):
            e.sub_((e - p.float()) * one_minus_d)

    @torch.no_grad()
    def copy_to(self, params) -> None:
        for e, p in zip(self.params, params):
            p.copy_(e)

    def state_dict(self) -> dict:
        return {"params": self.params, "num_updates": self.num_updates}

    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.params, state["params"]):
            dst.copy_(src)
        self.num_updates = int(state["num_updates"])
