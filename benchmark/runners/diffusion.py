"""A G-MeshDiffusion cell: the port's ``DiffusionTrainer.train_step`` in a
closed loop, one update after another, on one rank of the configuration's
deployment (its micro-batch, its accumulation steps).

The trainer is built as ``main_diffusion --mode train`` builds it from the
configuration (no mask file); the state is a ``DiffusionTrainState`` of a
U-Net holding the weights that ``inputs`` draws, with AdamW and the EMA at
the traffic's update count.  Update ``k`` takes its micro-batches from the
seed and the draw source ``step{k}``.  The reference is the plain copy in
``reference/diffusion``, given the same weights, grids and draws."""
from __future__ import annotations

import contextlib

import torch

from ..draws import KeyedDraws
from ..inputs import diffusion as inputs
from ..reference.diffusion.trainer import ReferenceDiffusion
from ..reference.diffusion.unet3d import UNet3D, UNet3DConfig

BETA1 = 0.9  # AdamW's, the port's and the reference's
FAULTS = ("unchanged", "half_batch")
OPT_SPAN = "bench.opt_ema"


def unet_config(module, cfg: dict):
    return module(data_ch=cfg["data_ch"], base_channels=cfg["base_channels"], ch_mult=tuple(cfg["ch_mult"]),
                  num_res_blocks=cfg["num_res_blocks"], dropout=cfg["dropout"], use_occ=cfg["use_occ_grid"],
                  remat=cfg["remat"], compute_dtype=cfg["compute_dtype"])


def parameter_shapes(cfg: dict) -> dict:
    """{name: shape} of the configuration's U-Net, from the reference's
    module built on the meta device (no memory)."""
    with torch.device("meta"):
        model = UNet3D(unet_config(UNet3DConfig, cfg))
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


class Cell:

    def __init__(self, config_path: str, traffic: dict, seed: int, device, fault: str | None = None):
        from gshell_tpu_torch.models.ema import EMA
        from gshell_tpu_torch.models.losses import make_optimizer
        from gshell_tpu_torch.models.unet3d import UNet3D as ProgramUNet
        from gshell_tpu_torch.models.unet3d import UNet3DConfig as ProgramConfig
        from gshell_tpu_torch.train.diffusion import DiffusionTrainConfig, DiffusionTrainer, DiffusionTrainState

        from ..harness import load_json

        if fault not in (None,) + FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.cfg = load_json(config_path)
        self.traffic, self.seed, self.fault = traffic, int(seed), fault
        self.device = torch.device(device)
        c = self.cfg
        self.accumulation = c["num_grad_acc_steps"]
        self.micro_batch = c["batch"] // c["deployment_ranks"]
        self.units_per_step = self.accumulation * self.micro_batch
        tcfg = DiffusionTrainConfig(data_ch=c["data_ch"], use_occ=c["use_occ_grid"],
                                    num_grad_acc_steps=self.accumulation // 2 if fault == "half_batch"
                                    else self.accumulation, lr=c["lr"], warmup=c["warmup"],
                                    grad_clip=c["grad_clip"], weight_decay=c["weight_decay"], ema_rate=c["ema_rate"],
                                    beta_min=c["beta_min"], beta_max=c["beta_max"], num_scales=c["num_scales"])
        unet_cfg = unet_config(ProgramConfig, c)
        self.trainer = DiffusionTrainer(tcfg, unet_cfg, device=self.device)
        self.shapes = parameter_shapes(c)
        with self.device:
            model = ProgramUNet(unet_cfg)
        with torch.no_grad():
            weights = self.weights()
            for name, p in model.named_parameters():
                p.copy_(weights[name])
            del weights
        params = list(model.parameters())
        opt = make_optimizer(params, c["lr"], c["warmup"], c["grad_clip"], c["weight_decay"])
        opt.count = traffic["start_count"]
        ema = EMA(params)
        ema.num_updates = traffic["start_count"]
        self.state = DiffusionTrainState(model=model, opt=opt, ema=ema, step=traffic["start_count"])
        self.pool = inputs.make_pool(c, self.seed, self.device, traffic["pool_shapes"])

    def notes(self) -> str:
        return ""

    def weights(self) -> dict:
        """The initial weights, made anew from the seed (not held between uses)."""
        return inputs.make_weights(self.shapes, self.seed, self.device)

    def batch(self, k: int) -> dict:
        b = inputs.batch(self.pool, self.seed, k, self.accumulation, self.micro_batch)
        if self.fault == "half_batch":
            b = {n: t[: self.accumulation // 2] for n, t in b.items()}
        return b

    def step(self, k: int):
        """Update ``k`` → its loss (a float: the trainer waits for it)."""
        if self.fault == "unchanged":
            before = [p.detach().clone() for p in self.state.model.parameters()]
        _, m = self.trainer.train_step(self.state, KeyedDraws(self.seed, self.device, f"step{k}"), self.batch(k))
        if self.fault == "unchanged":
            with torch.no_grad():
                for p, b in zip(self.state.model.parameters(), before):
                    p.copy_(b)
        return m["loss"]

    @contextlib.contextmanager
    def spans(self):
        """The optimizer and EMA updates inside a span ``bench.opt_ema``."""
        from torch.profiler import record_function

        opt, ema = self.state.opt, self.state.ema

        def wrap(fn):
            def inner(*a, **kw):
                with record_function(OPT_SPAN):
                    return fn(*a, **kw)
            return inner

        opt.step, ema.update = wrap(opt.step), wrap(ema.update)
        try:
            yield
        finally:
            del opt.step, ema.update

    def follow(self, n: int) -> dict:
        """Updates 0 .. n−1, recorded as :mod:`benchmark.compare` reads them."""
        losses, grad, record = [], {}, []
        names = [name for name, _ in self.state.model.named_parameters()]
        for k in range(n):
            losses.append(float(self.step(k)))
            if k == 0:
                grad = moment_norms(names, self.state.opt.mu)
            record.append(changes(names, list(self.state.model.parameters()), self.state.ema.params,
                                  self.weights()))
        return {"losses": losses, "grad": grad, "changes": record}

    def free(self) -> None:
        self.state = self.trainer = None

    def reference(self, n: int, lower: bool = False, channels_last: bool = False) -> dict:
        """The plain reference's record of the same ``n`` updates; ``lower``:
        its convolutions' and dense layers' operands in float8, the control;
        ``channels_last``: its convolutions in that layout."""
        ref = ReferenceDiffusion(self.cfg, self.weights(), self.device, self.traffic["start_count"], fp8=lower,
                                 channels_last=channels_last)
        names = [name for name, _ in ref.model.named_parameters()]
        losses, grad, record = [], {}, []
        for k in range(n):
            b = inputs.batch(self.pool, self.seed, k, self.accumulation, self.micro_batch)
            losses.append(ref.train_step(KeyedDraws(self.seed, self.device, f"step{k}"), b))
            if k == 0:
                grad = moment_norms(names, ref.opt.mu)
            record.append(changes(names, ref.params, ref.ema.params, self.weights()))
        return {"losses": losses, "grad": grad, "changes": record}


@torch.no_grad()
def moment_norms(names, moments) -> dict:
    return {n: float(torch.linalg.vector_norm(m)) / (1.0 - BETA1) for n, m in zip(names, moments)}


@torch.no_grad()
def changes(names, params, ema_params, start: dict) -> dict:
    out = {}
    for n, p, e in zip(names, params, ema_params):
        out[n] = float(torch.linalg.vector_norm(p.detach().float() - start[n]))
        out["ema/" + n] = float(torch.linalg.vector_norm(e - start[n]))
    return out
