"""What the port's command-line entry points share: option parsing, the
device, the model built from a :class:`~gshell_tpu_torch.utils.config.Flags`
and the seeded ground-truth light and material of synthetic runs."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..geometry.flexi_geometry import FlexiGeometryConfig, GShellFlexiGeometry
from ..geometry.geometry import GeometryConfig, GShellGeometry
from ..geometry.mlp import MLPConfig
from ..render.light import create_trainable_env_rnd
from ..render.material import MLPTexture3DConfig, default_kd_ks_min_max, init_mlp_texture
from ..render.render import RenderFlags
from ..utils.config import Flags, learning_rates
from ..utils.rng import TorchDraws
from .reconstruct import Reconstructor, TrainConfig

# Seeds of the synthetic runs' ground-truth light and material; drawn on the
# CPU, so the ground truth is the same whatever device renders it.
GT_LIGHT_SEED, GT_MATERIAL_SEED, GT_LIGHT_RES = 42, 43, 256

_TRUE, _FALSE = ("1", "true", "yes", "on"), ("0", "false", "no", "off")


def sync(device) -> None:
    """Wait for ``device``'s queued work (a no-op off the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_bool(text) -> bool:
    """``1/true/yes/on`` → True, ``0/false/no/off`` → False (any case);
    anything else raises."""
    if isinstance(text, bool):
        return text
    word = str(text).strip().lower()
    if word in _TRUE:
        return True
    if word in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r} (use 0/1, true/false, yes/no)")


def add_bool(parser: argparse.ArgumentParser, name: str, default: bool = False, help: str = ""):
    """A boolean option: ``--name`` alone is true, ``--name 0|1|no|yes|…``
    sets it."""
    parser.add_argument(name, nargs="?", const=True, default=default, type=parse_bool,
                        metavar="0|1", help=help)


def resolve_device(name: str, prog: str) -> torch.device:
    """``torch.device(name)``; a CUDA device that is not there exits with a
    message (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run on the CPU")
    return dev


def material_config(flags: Flags) -> MLPTexture3DConfig:
    aabb = np.asarray(flags.aabb, np.float32).reshape(2, 3)
    return MLPTexture3DConfig(
        channels=6, aabb_min=tuple(aabb[0].tolist()), aabb_max=tuple(aabb[1].tolist()),
        min_max=default_kd_ks_min_max(flags.kd_min[:3], flags.kd_max[:3], flags.ks_min, flags.ks_max),
    )


def reconstructor_from_flags(flags: Flags, device, n_samples: int | None = None) -> Reconstructor:
    """The geometry, material, render flags and trainer a run of ``flags``
    uses (``train_gshell.py``'s settings); ``n_samples`` overrides the
    config's.  FlexiCubes on the ``voxel_grid`` when ``use_flexicubes`` is
    set, else marching tets on ``gshell_grid``.  ``max_pairs`` sizes stage
    A's pair buffer; the stage-B kernel has no per-tile cap, so
    ``max_per_tile`` is not read (as on JAX's Pallas path)."""
    flexi = flags.use_flexicubes
    gcfg = (FlexiGeometryConfig if flexi else GeometryConfig)(
        grid_res=flags.voxel_grid if flexi else flags.gshell_grid, scale=flags.mesh_scale,
        boxscale=tuple(flags.boxscale),
        mlp=MLPConfig(n_freq=flags.n_freq, d_hidden=flags.d_hidden, n_hidden=flags.n_hidden,
                      skip_in=tuple(flags.skip_in)),
        use_sdf_mlp=flags.use_sdf_mlp, use_msdf_mlp=flags.use_msdf_mlp,
        msdf_reg_open_scale=flags.msdf_reg_open_scale, msdf_reg_close_scale=flags.msdf_reg_close_scale,
        sdf_regularizer=flags.sdf_regularizer, eikonal_scale=flags.eikonal_scale,
        lambda_kd=flags.lambda_kd, lambda_ks=flags.lambda_ks, lambda_nrm=flags.lambda_nrm,
        lambda_chroma=flags.lambda_chroma, lambda_diffuse=flags.lambda_diffuse,
        lambda_specular=flags.lambda_specular, use_eikonal=flags.use_eikonal, use_depth=flags.use_depth,
        use_img_2nd_layer=flags.use_img_2nd_layer, use_depth_2nd_layer=flags.use_depth_2nd_layer,
        total_iters=flags.iter, view_batch_mode=flags.view_batch_mode,
    )
    rflags = RenderFlags(
        resolution=tuple(flags.train_res), n_samples=flags.n_samples if n_samples is None else n_samples,
        spp=flags.spp, bsdf=flags.bsdf, use_denoiser=flags.denoiser == "bilateral",
        denoiser_demodulate=flags.denoiser_demodulate, shade_budget=flags.shade_budget,
        max_pairs=flags.max_pairs,
    )
    lr_pos, lr_mat, lr_lgt = learning_rates(flags)
    tcfg = TrainConfig(lr_pos=lr_pos, lr_mat=lr_mat, lr_lgt=lr_lgt, loss=flags.loss, iters=flags.iter,
                       batch=flags.batch)
    geo = (GShellFlexiGeometry if flexi else GShellGeometry)(gcfg, device)
    return Reconstructor(geo, material_config(flags), rflags, tcfg)


def gt_light_material(mat_cfg: MLPTexture3DConfig, device):
    """(light, material parameters) of a synthetic run's ground truth."""
    light = create_trainable_env_rnd(TorchDraws(torch.Generator().manual_seed(GT_LIGHT_SEED)),
                                     GT_LIGHT_RES, device=device)
    mat = init_mlp_texture(TorchDraws(torch.Generator().manual_seed(GT_MATERIAL_SEED)), mat_cfg, device)
    return light, mat
