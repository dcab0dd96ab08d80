"""The plain reference of one G-Shell-on-FlexiCubes train step.

What ``train/setup.reconstructor_from_flags`` builds for a configuration
with ``use_flexicubes`` (upstream ``train_gflexicubes_deepfashion.py``), in
plain PyTorch and float32 with TF32 off unless ``tf32`` asks for the lower
precision (the control of the benchmark's comparison): the FlexiCubes
geometry beside it on ``voxel_grid``, the material, render flags, losses
and the step of ``recon/trainer.py`` (non-finite zeroing, the gradient
tweaks, three Adam groups with their schedule, clamps), with
``cube_weights`` in the geometry group at ``lr_pos``, as ``deform``.  It
imports nothing of the port and runs no hand kernel.

Departures from the JAX package, the port's and so this copy's (each a
fault of the JAX trainer, found when the port was written): the JAX
FlexiCubes trainer passes ``shadow_ko`` to a tick that takes none (a
``TypeError`` at its first step) and hands that tick an unresolved
``"mesh_splat"``; its ``tx_geo`` masks leave ``cube_weights`` out, so Adam
never sees them and their raw gradient is added as the update.  Here the
tick builds the cut mesh's splat occluder and ``cube_weights`` take Adam at
``lr_pos``."""
from __future__ import annotations

import numpy as np
import torch

from ..recon.geometry.mlp import MLPConfig
from ..recon.ops.image_loss import create_loss
from ..recon.render.material import MLPTexture3DConfig, default_kd_ks_min_max
from ..recon.render.render import RenderFlags
from ..recon.trainer import ReferenceReconstructor, State, leaves, lr_factor
from ..recon.utils.config import learning_rates, load_flags
from .geometry import FlexiGeometryConfig, GShellFlexiGeometry

# the geometry optimizer's groups in order, each one's LR as a multiple of lr_pos
GEO_LR_SCALE = {"deform": 1.0, "cube_weights": 1.0, "msdf": 1.0, "sdf_net": 1e-2}


class ReferenceFlexiReconstructor(ReferenceReconstructor):
    """``recon/trainer.ReferenceReconstructor``'s step over the FlexiCubes
    geometry; its first step's ``evaluations`` are the SDF MLP on the whole
    lattice with gradient, the eikonal samples and the material MLP."""

    def __init__(self, config_path: str, device, tf32: bool = False):
        flags = load_flags(config_path)
        if (not flags.use_flexicubes or not flags.use_sdf_mlp or flags.use_msdf_mlp or flags.use_depth
                or flags.use_img_2nd_layer or flags.use_depth_2nd_layer):
            raise ValueError("the reference covers FlexiCubes with an SDF MLP and a direct mSDF, "
                             "one depth layer and no depth supervision")
        self.tf32 = tf32
        self.device = torch.device(device)
        gcfg = FlexiGeometryConfig(
            grid_res=flags.voxel_grid, scale=flags.mesh_scale, boxscale=tuple(flags.boxscale),
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
        self.geo = GShellFlexiGeometry(gcfg, self.device)

    def make_state(self, params_geo: dict, params_mat: dict, light_base, step: int) -> State:
        def leaf(t):
            return t.detach().clone().to(self.device).requires_grad_(True)

        params_geo = {k: {n: [leaf(t) for t in v] for n, v in params_geo[k].items()} if k.endswith("_net")
                      else leaf(params_geo[k]) for k in GEO_LR_SCALE}
        params_mat = {"tables": leaf(params_mat["tables"]), "mlp": [leaf(w) for w in params_mat["mlp"]]}
        light_base = leaf(light_base)
        opt_geo = torch.optim.Adam([{"params": leaves(v), "lr": self.lr_pos * GEO_LR_SCALE[k]}
                                    for k, v in params_geo.items()], eps=1e-8)
        opt_mat = torch.optim.Adam(leaves(params_mat), lr=self.lr_mat, eps=1e-8)
        opt_lgt = torch.optim.Adam([light_base], lr=self.lr_lgt, eps=1e-8)
        opts = (opt_geo, opt_mat, opt_lgt)
        scheds = tuple(torch.optim.lr_scheduler.LambdaLR(o, lr_factor) for o in opts)
        return State(params_geo, params_mat, light_base, opts, scheds, step)
