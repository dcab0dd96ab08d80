"""G-MeshDiffusion trainer: gradient accumulation, AdamW, EMA, checkpoints
(PyTorch twin of the monolithic path of ``gshell_tpu/train/diffusion.py``).

One ``train_step`` runs ``num_grad_acc_steps`` microbatches through the
loss and its backward, averages their gradients, takes one optimizer step
and updates the EMA.  Microbatch ``i`` takes its loss draws from
``draws.child("micro{i}")``; dropout draws from torch's generator, seeded
for the step from ``draws`` (``"dropout_seed"``) inside ``fork_rng``, so a
step is a function of its draws and ``torch.utils.checkpoint`` replays the
same masks.  The precision is set explicitly (``unet3d.compute_policy``):
``compute_dtype`` "float32" is IEEE float32 with TF32 off, "bfloat16" is
autocast with float32 GroupNorm statistics.

Data parallel (``mesh``, a ``DeviceMesh``; JAX's ``DiffusionTrainer(mesh=)``):
rank 0's initial parameters are broadcast, each rank runs the microbatches
on its rows of the global batch (``parallel.sharding.batch_rows``) with
those rows of the global draws, the gradients are averaged across ranks
once after the microbatch loop, and the clip, AdamW and the EMA then run
alike on every rank.  The dropout seed folds in the rank, so the ranks'
rows get masks of their own.  Rank 0 writes the checkpoint."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..models.ema import EMA
from ..models.losses import ddpm_loss, make_optimizer
from ..models.sde import make_vpsde
from ..models.unet3d import UNet3D, UNet3DConfig, compute_policy, init_unet
from ..parallel.sharding import all_reduce_, average_gradients, broadcast_parameters, mesh_group, world
from ..utils import checkpoint


@dataclasses.dataclass(frozen=True)
class DiffusionTrainConfig:
    """The JAX trainer's settings that the step reads (the grid size and the
    batch are the batch tensor's shape; snapshots are the caller's)."""
    data_ch: int = 4
    use_occ: bool = True
    num_grad_acc_steps: int = 4
    lr: float = 1e-5
    warmup: int = 5000
    grad_clip: float = 1.0
    weight_decay: float = 1e-5
    ema_rate: float = 0.9999
    beta_min: float = 0.1
    beta_max: float = 20.0
    num_scales: int = 1000


@dataclasses.dataclass
class DiffusionTrainState:
    model: UNet3D  # holds the parameters
    opt: object  # models.losses.AdamW
    ema: EMA
    step: int = 0


class DiffusionTrainer:
    def __init__(self, cfg: DiffusionTrainConfig, unet_cfg: Optional[UNet3DConfig] = None,
                 feature_mask=None, occ_mask=None, device="cpu", mesh=None):
        self.cfg = cfg
        self.unet_cfg = unet_cfg or UNet3DConfig(data_ch=cfg.data_ch, use_occ=cfg.use_occ)
        self.device = torch.device(device)
        self.group = mesh_group(mesh) if mesh is not None else None
        self.rank, self.world = world(self.group)
        self.allreduce_seconds = 0.0  # the last step's gradient average
        self.sde = make_vpsde(cfg.beta_min, cfg.beta_max, cfg.num_scales, device=self.device)
        self.feature_mask, self.occ_mask = feature_mask, occ_mask

    def policy(self):
        return compute_policy(self.unet_cfg.compute_dtype, self.device.type)

    def init_state(self, draws) -> DiffusionTrainState:
        with self.device:  # built where it trains: the default init of 411M parameters is slow on the host
            model = init_unet(UNet3D(self.unet_cfg), draws)
        broadcast_parameters(list(model.parameters()) + list(model.buffers()), self.group)
        params = list(model.parameters())
        c = self.cfg
        opt = make_optimizer(params, c.lr, c.warmup, c.grad_clip, c.weight_decay)
        return DiffusionTrainState(model=model, opt=opt, ema=EMA(params))

    def eps_fn(self, model: UNet3D):
        """``(x, x_occ, labels) → (eps, eps_occ)`` of ``model`` in eval mode,
        masked, under the trainer's precision."""
        model.eval()

        def fn(x, x_occ, labels):
            with self.policy():
                return model(x, x_occ, labels, feature_mask=self.feature_mask, occ_mask=self.occ_mask)

        return fn

    def train_step(self, state: DiffusionTrainState, draws, batch: dict):
        """``batch``: {"grid": (A, B, C, D, D, D), "occgrid": (A, B, 1, 2D,
        2D, 2D)} with A = ``num_grad_acc_steps`` microbatches, B this rank's
        rows (B·W in all) → (state, {"loss", "grad_norm"}), the loss the
        global batch's; the state is updated in place."""
        a = self.cfg.num_grad_acc_steps
        lead = batch["grid"].shape[0]
        if lead != a:
            raise ValueError(f"batch leading (accumulation) axis is {lead} but num_grad_acc_steps={a}")
        b = batch["grid"].shape[1]
        rows = (self.rank * b, self.world * b)
        model = state.model
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        seed = int(draws.randint("dropout_seed", (1,), 0, 2 ** 62)[0]) + self.rank
        loss_sum = torch.zeros((), device=self.device)
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices, device_type=self.device.type):
            torch.manual_seed(seed)
            for i in range(a):
                mb = {k: v[i] for k, v in batch.items()}
                with self.policy():
                    loss = ddpm_loss(self.sde, model, draws.child(f"micro{i}"), mb,
                                     self.feature_mask, self.occ_mask, rows=rows)
                    loss.backward()
                loss_sum += loss.detach()
        if self.group is not None:
            self.allreduce_seconds = average_gradients(params, self.group)
            all_reduce_(loss_sum, self.group).div_(self.world)
        grads = [p.grad.div_(a) for p in params]
        grad_norm = state.opt.step(grads)
        state.ema.update(params, self.cfg.ema_rate)
        state.step += 1
        return state, {"loss": float(loss_sum) / a, "grad_norm": grad_norm}

    def save_checkpoint(self, path: str, state: DiffusionTrainState) -> None:
        """Rank 0 writes; every rank waits for it (a barrier)."""
        if self.rank == 0:
            checkpoint.save(path, {"params": state.model.state_dict(), "opt": state.opt.state_dict(),
                                   "ema": state.ema.state_dict(), "step": state.step})
        if self.group is not None:
            dist.barrier(group=self.group)

    def restore_checkpoint(self, path: str, state: DiffusionTrainState) -> DiffusionTrainState:
        """Loads ``path`` into ``state``; without a checkpoint ``state`` is
        returned as it is."""
        saved = checkpoint.restore(path, map_location=self.device)
        if saved is None:
            return state
        state.model.load_state_dict(saved["params"])
        state.opt.load_state_dict(saved["opt"])
        state.ema.load_state_dict(saved["ema"])
        state.step = int(saved["step"])
        return state
