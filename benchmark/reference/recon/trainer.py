"""The plain reference of one reconstruction train step.

A frozen copy of the port's train step (``train/reconstruct.py`` and
``train/setup.py`` at the commit the benchmark was written against): the
geometry, material, render flags and Adam groups that a run of a
configuration file builds, the same losses, non-finite zeroing, gradient
tweaks, three Adam groups with their schedule, and clamps.  It runs the
copied modules beside it, where the two hand kernels are replaced by their
plain versions, and computes in float32 with TF32 off unless ``tf32`` asks
for the lower precision (the control of the benchmark's comparison).  It
imports nothing of the port."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .geometry import mlp as mlp_mod
from .geometry.geometry import GeometryConfig, GShellGeometry
from .geometry.mlp import MLPConfig
from .ops.image_loss import create_loss
from .render.light import update_pdf
from .render.material import MLPTexture3DConfig, default_kd_ks_min_max
from .render.render import RenderFlags
from .utils.config import load_flags, learning_rates

# the geometry optimizer's groups in order, each one's LR as a multiple of lr_pos
GEO_LR_SCALE = {"deform": 1.0, "msdf": 1.0, "sdf": 1e-2, "sdf_net": 1e-2}
SHADOW_RAMP_ITERS = 1000
SHADOW_KO = 16


def lr_factor(count: int) -> float:
    return 10.0 ** (-count * 0.0002)


@contextlib.contextmanager
def precision(tf32: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [t for v in tree for t in leaves(v)]


@dataclasses.dataclass
class State:
    params_geo: dict
    params_mat: dict
    light_base: torch.Tensor
    optimizers: tuple
    schedulers: tuple
    step: int


class ReferenceReconstructor:
    """What ``train/setup.reconstructor_from_flags`` builds for a marching-tets
    configuration file, in plain PyTorch."""

    def __init__(self, config_path: str, device, tf32: bool = False):
        flags = load_flags(config_path)
        if (flags.use_flexicubes or not flags.use_sdf_mlp or flags.use_msdf_mlp or flags.use_depth
                or flags.use_img_2nd_layer or flags.use_depth_2nd_layer):
            raise ValueError("the reference covers marching tets with an SDF MLP and a direct mSDF, "
                             "one depth layer and no depth supervision")
        self.tf32 = tf32
        self.device = torch.device(device)
        gcfg = GeometryConfig(
            grid_res=flags.gshell_grid, scale=flags.mesh_scale, boxscale=tuple(flags.boxscale),
            mlp=MLPConfig(n_freq=flags.n_freq, d_hidden=flags.d_hidden, n_hidden=flags.n_hidden,
                          skip_in=tuple(flags.skip_in)),
            use_sdf_mlp=True, use_msdf_mlp=False,
            msdf_reg_open_scale=flags.msdf_reg_open_scale, msdf_reg_close_scale=flags.msdf_reg_close_scale,
            sdf_regularizer=flags.sdf_regularizer, eikonal_scale=flags.eikonal_scale,
            lambda_kd=flags.lambda_kd, lambda_ks=flags.lambda_ks, lambda_nrm=flags.lambda_nrm,
            lambda_chroma=flags.lambda_chroma, lambda_diffuse=flags.lambda_diffuse,
            lambda_specular=flags.lambda_specular, use_eikonal=flags.use_eikonal,
            total_iters=flags.iter, view_batch_mode=flags.view_batch_mode,
        )
        self.flags = RenderFlags(
            resolution=tuple(flags.train_res), n_samples=flags.n_samples, spp=flags.spp, bsdf=flags.bsdf,
            use_denoiser=flags.denoiser == "bilateral", denoiser_demodulate=flags.denoiser_demodulate,
            shade_budget=flags.shade_budget, max_pairs=flags.max_pairs,
        )
        aabb = np.asarray(flags.aabb, np.float32).reshape(2, 3)
        self.mat_cfg = MLPTexture3DConfig(
            channels=6, aabb_min=tuple(aabb[0].tolist()), aabb_max=tuple(aabb[1].tolist()),
            min_max=default_kd_ks_min_max(flags.kd_min[:3], flags.kd_max[:3], flags.ks_min, flags.ks_max))
        self.lr_pos, self.lr_mat, self.lr_lgt = learning_rates(flags)
        self.image_loss_fn = create_loss(flags.loss)
        self.geo = GShellGeometry(gcfg, self.device)

    def make_state(self, params_geo: dict, params_mat: dict, light_base, step: int) -> State:
        def leaf(t):
            return t.detach().clone().to(self.device).requires_grad_(True)

        params_geo = {k: {n: [leaf(t) for t in v] for n, v in params_geo[k].items()} if k.endswith("_net")
                      else leaf(params_geo[k]) for k in GEO_LR_SCALE if k in params_geo}
        params_mat = {"tables": leaf(params_mat["tables"]), "mlp": [leaf(w) for w in params_mat["mlp"]]}
        light_base = leaf(light_base)
        opt_geo = torch.optim.Adam([{"params": leaves(v), "lr": self.lr_pos * GEO_LR_SCALE[k]}
                                    for k, v in params_geo.items()], eps=1e-8)
        opt_mat = torch.optim.Adam(leaves(params_mat), lr=self.lr_mat, eps=1e-8)
        opt_lgt = torch.optim.Adam([light_base], lr=self.lr_lgt, eps=1e-8)
        opts = (opt_geo, opt_mat, opt_lgt)
        scheds = tuple(torch.optim.lr_scheduler.LambdaLR(o, lr_factor) for o in opts)
        return State(params_geo, params_mat, light_base, opts, scheds, step)

    def train_step(self, state: State, draws, target: dict) -> dict:
        """One step in place on ``state`` → {"total", "img_loss", "reg_loss",
        "evaluations"}: the losses as floats and the MLP evaluations of the
        forward (:data:`geometry.mlp.evaluations`, the recomputation of the
        backward left out)."""
        with precision(self.tf32):
            it = state.step
            shadow_scale = min(it / SHADOW_RAMP_ITERS, 1.0)
            denoiser_sigma = max(shadow_scale * 2.0, 1e-4)
            light = update_pdf(state.light_base)
            mlp_mod.evaluations.clear()
            img_loss, depth_loss, reg_loss, _ = self.geo.tick(
                draws, state.params_geo, state.params_mat, self.mat_cfg, light, target, it, self.flags,
                self.image_loss_fn, use_shadows=True, shadow_scale=shadow_scale,
                denoiser_sigma=denoiser_sigma, shadow_ko=SHADOW_KO)
            evaluations = list(mlp_mod.evaluations)
            total = img_loss + depth_loss + reg_loss
            for opt in state.optimizers:
                opt.zero_grad(set_to_none=True)
            total.backward()
            groups = (state.params_geo, state.params_mat, [state.light_base])
            with torch.no_grad():
                for p in leaves(groups):
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    p.grad.copy_(torch.where(torch.isfinite(p.grad), p.grad, 0.0))
                state.params_mat["tables"].grad.mul_(1.0 / 8.0)
                state.light_base.grad.mul_(64.0)
            for opt, sched in zip(state.optimizers, state.schedulers):
                opt.step()
                sched.step()
            self.geo.clamp_params(state.params_geo)
            with torch.no_grad():
                state.light_base.clamp_(min=1e-4)
            state.step = it + 1
        return {"total": float(total.detach()), "img_loss": float(img_loss.detach()),
                "reg_loss": float(reg_loss.detach()),
                "evaluations": evaluations}
