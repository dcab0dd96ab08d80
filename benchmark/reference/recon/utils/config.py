"""Unified config system for reconstruction runs (the port's copy of
``gshell_tpu/utils/config.py``: the same fields, defaults and behaviour).

The reference uses argparse + a hardcoded FLAGS dict overridden by JSON
(``train_gshelltet_deepfashion.py:504-611``).  Here: one dataclass with the
same field names/defaults, overridable from the same JSON config files
(``configs/*.json`` are drop-in compatible) and dotted CLI overrides.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Flags:
    # core run scale (ref argparse defaults)
    config: Optional[str] = None
    iter: int = 5000
    batch: int = 1
    spp: int = 1
    train_res: Tuple[int, int] = (512, 512)
    texture_res: Tuple[int, int] = (1024, 1024)
    display_res: Optional[Tuple[int, int]] = None
    save_interval: int = 1000
    learning_rate: object = 0.01  # float or [geo, mat(, light)]
    min_roughness: float = 0.08
    background: str = "checker"
    loss: str = "logl1"
    out_dir: Optional[str] = None
    ref_mesh: Optional[str] = None
    validate: bool = True
    n_samples: int = 4
    bsdf: str = "pbr"
    denoiser: str = "bilateral"
    denoiser_demodulate: bool = True
    msdf_reg_open_scale: float = 1e-6
    msdf_reg_close_scale: float = 3e-6
    eikonal_scale: Optional[float] = None
    sdf_regularizer: float = 0.2
    trainset_path: Optional[str] = None
    testset_path: str = ""
    # hardcoded FLAGS block (ref :541-596)
    gshell_grid: int = 64
    mesh_scale: float = 1.4
    envlight: Optional[str] = None
    env_scale: float = 1.0
    probe_res: int = 256
    learn_lighting: bool = True
    lock_light: bool = False
    lock_pos: bool = False
    laplace_scale: float = 3000.0
    kd_min: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0, 0.0])
    kd_max: List[float] = dataclasses.field(default_factory=lambda: [1.0, 1.0, 1.0, 1.0])
    ks_min: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.001, 0.0])
    ks_max: List[float] = dataclasses.field(default_factory=lambda: [0.0, 1.0, 1.0])
    clip_max_norm: float = 0.0
    cam_near_far: Tuple[float, float] = (0.1, 1000.0)
    lambda_kd: float = 0.1
    lambda_ks: float = 0.05
    lambda_nrm: float = 0.025
    lambda_chroma: float = 0.0
    lambda_diffuse: float = 0.15
    lambda_specular: float = 0.0025
    use_sdf_mlp: bool = True
    use_msdf_mlp: bool = False
    use_eikonal: bool = True
    # depth / 2nd-layer supervision (ref FLAGS :577-579, default off)
    use_depth: bool = False
    use_img_2nd_layer: bool = False
    use_depth_2nd_layer: bool = False
    layers: int = 1  # depth-peel layers for DatasetMesh GT (ref -l flag)
    # Render the synthetic DatasetMesh ground truth WITH the shadow field
    # (reference parity: dataset_mesh.py renders GT through the same shadowed
    # pipeline as training).  Without this, training (shadowed) fits
    # shadow-free targets and compensates by over-brightening materials.
    gt_shadows: bool = False
    sdf_mlp_pretrain_steps: int = 1000
    use_mesh_msdf_reg: bool = True
    sphere_init: bool = False
    sphere_init_norm: float = 0.5
    n_hidden: int = 6
    d_hidden: int = 256
    n_freq: int = 6
    skip_in: Tuple[int, ...] = (3,)
    boxscale: List[float] = dataclasses.field(default_factory=lambda: [1.0, 1.0, 1.0])
    aabb: List[float] = dataclasses.field(default_factory=lambda: [-1, -1, -1, 1, 1, 1])
    random_textures: bool = False
    use_flexicubes: bool = False
    voxel_grid: int = 80  # FlexiCubes resolution when use_flexicubes
    # foreground-pixel compaction budget (fraction of pixels shaded; None →
    # exact full-image path). Overflow is counted in the px_dropped metric.
    shade_budget: Optional[float] = 0.5
    # multi-view render mode in tick: 'map' (residuals kept — fastest when
    # it fits), 'map_remat' (per-view backward re-render — lowest memory),
    # 'vmap' (XLA batches the whole pipeline)
    view_batch_mode: str = "map_remat"
    # tiled-raster budgets (None → auto); overflow shows in raster_dropped
    max_pairs: Optional[int] = None
    max_per_tile: int = 1024

    def apply_json(self, path: str) -> "Flags":
        data = json.load(open(path))
        known = {f.name for f in dataclasses.fields(self)}
        for k, v in data.items():
            if k in known:
                setattr(self, k, v)
        return self


def load_flags(config_path: Optional[str] = None, **overrides) -> Flags:
    flags = Flags()
    if config_path:
        flags.apply_json(config_path)
        flags.config = config_path
    for k, v in overrides.items():
        if v is not None:
            setattr(flags, k, v)
    if flags.display_res is None:
        flags.display_res = tuple(flags.train_res)
    if flags.spp < 1:
        raise ValueError(f"config error: spp must be >= 1 (got {flags.spp})")
    if flags.n_samples < 1:
        raise ValueError(
            f"config error: n_samples must be >= 1 (got {flags.n_samples})"
        )
    return flags


def learning_rates(flags: Flags):
    """(lr_pos, lr_mat, lr_lgt) from the reference convention (ref :301-304)."""
    lr = flags.learning_rate
    if isinstance(lr, (list, tuple)):
        lr_pos = lr[0]
        lr_mat = lr[1] if len(lr) > 1 else lr[0]
        lr_lgt = lr[2] if len(lr) > 2 else lr_mat * 6.0
    else:
        lr_pos = lr_mat = lr
        lr_lgt = lr * 6.0
    return lr_pos, lr_mat, lr_lgt
