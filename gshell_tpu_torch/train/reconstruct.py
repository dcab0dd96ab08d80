"""Inverse-rendering (multiview reconstruction) trainer — PyTorch twin of
``gshell_tpu/train/reconstruct.py``.

One ``train_step``: extraction → shadow occluder → render every view →
losses → backward → non-finite-gradient zeroing → the reference's gradient
tweaks (hash tables ÷8, light ×64) → three Adam groups with LR
10^(−0.0002·it) → clamps.  Geometry sub-groups, in JAX's order: ``deform``
(and FlexiCubes' ``cube_weights``) at ``lr_pos``; ``msdf`` / ``msdf_net``
at ``lr_pos``, or ``lr_pos·1e-2`` under ``use_msdf_mlp``; ``sdf`` /
``sdf_net`` at ``lr_pos·1e-2``.

The shadow occluder (``shadow_source``): ``"mesh_splat"`` (the default) is
the cut mesh's surface splat, which the tick builds; ``"sdf"`` is the
legacy template-SDF proxy, the negated lattice SDF built here once a step,
swept into a shadow field (``shadow_method`` "field") or marched along each
ray ("march").  It occludes with the template regions the mSDF cuts away,
and the JAX code names it the cause of its black renders; no config or
flag selects it, only the Python API.

The main path runs f32 matrix products in full precision: TF32 is switched
off for cuBLAS and cuDNN when a :class:`Reconstructor` is built.

``spatial=(n_view, n_band)`` renders the views in (view, band) cells over
the ranks of a process group (``parallel/spatial.py``; JAX's
``Reconstructor(mesh=…)``): every rank computes the replicated work, the
gradients are averaged across ranks before the non-finite zeroing and the
reference's tweaks, and the metrics are averaged across ranks."""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..geometry.flexi_geometry import GShellFlexiGeometry
from ..ops.image_loss import create_loss
from ..ops.shade import make_sdf_visibility, make_shadow_field
from ..parallel.sharding import average_gradients, broadcast_parameters, default_group, mean_metrics
from ..parallel.spatial import CellGrid
from ..render.light import update_pdf
from ..render.material import MLPTexture3DConfig, init_mlp_texture
from ..render.render import RenderFlags


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_pos: float = 0.03
    lr_mat: float = 0.005
    lr_lgt: Optional[float] = None  # default lr_pos·6
    loss: str = "logl1"
    iters: int = 5000
    batch: int = 2
    shadow_ramp_iters: int = 1000
    use_shadows: bool = True
    shadow_method: str = "field"  # "field" (swept) or "march"; shadow_source "sdf" only
    shadow_ko: int = 16
    shadow_source: str = "mesh_splat"  # or "sdf", the legacy template-SDF proxy


# The geometry optimizer's groups, in order, and each one's learning rate as
# a multiple of lr_pos (FlexiCubes adds ``cube_weights``, trained as
# ``deform``); the mSDF's under ``use_msdf_mlp`` is MSDF_MLP_LR_SCALE
GEO_LR_SCALE = {"deform": 1.0, "cube_weights": 1.0, "msdf": 1.0, "msdf_net": 1.0, "sdf": 1e-2,
                "sdf_net": 1e-2}
MSDF_MLP_LR_SCALE = 1e-2


def lr_factor(count: int) -> float:
    """The reference's LR schedule 10^(−0.0002·count)."""
    return 10.0 ** (-count * 0.0002)


@dataclasses.dataclass
class TrainState:
    params_geo: dict
    params_mat: dict
    light_base: torch.Tensor
    optimizers: tuple  # (geometry, material, light) torch.optim.Adam
    schedulers: tuple  # matching LambdaLR
    step: int = 0


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


class Reconstructor:
    """The trainer of a tets (``geometry.GShellGeometry``) or a FlexiCubes
    (``flexi_geometry.GShellFlexiGeometry``) geometry."""

    def __init__(self, geometry, mat_cfg: MLPTexture3DConfig,
                 flags: RenderFlags, tcfg: TrainConfig = TrainConfig(), spatial: Optional[tuple] = None,
                 group=None):
        """``spatial``: (n_view, n_band) cells; the batch must be n_view and
        the image height divisible by n_band.  ``group``: the process group
        the cells split over (default: the default group when
        ``torch.distributed`` is initialized, else one process renders
        every cell)."""
        # full-f32 products on the main path (cuBLAS and cuDNN default to TF32
        # in places); the JAX reference computes in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.geo = geometry
        self.mat_cfg = mat_cfg
        self.flags = flags
        self.tcfg = tcfg
        self.device = geometry.device
        self.image_loss_fn = create_loss(tcfg.loss)
        self.lr_lgt = tcfg.lr_lgt if tcfg.lr_lgt is not None else tcfg.lr_pos * 6.0
        if tcfg.shadow_source not in ("mesh_splat", "sdf"):
            raise ValueError(f"shadow_source {tcfg.shadow_source!r}: mesh_splat or sdf")
        if tcfg.shadow_method not in ("field", "march"):
            raise ValueError(f"shadow_method {tcfg.shadow_method!r}: field or march")
        if tcfg.shadow_source == "sdf" and isinstance(geometry, GShellFlexiGeometry):
            raise ValueError(
                "shadow_source 'sdf' is a marching-tets option: the FlexiCubes field is inside-negative "
                "like the tets one, but JAX's FlexiCubes sdf_lattice already negates it, so the trainer's "
                "second negation would mark the exterior solid, and JAX's FlexiCubes trainer cannot run "
                "to be compared; use the default 'mesh_splat'")
        self.spatial = None
        if spatial is not None:
            n_view, n_band = spatial
            if tcfg.batch != n_view:
                raise ValueError(f"spatial {spatial}: the batch ({tcfg.batch}) must equal n_view")
            if flags.resolution[0] % n_band:
                raise ValueError(f"spatial {spatial}: {flags.resolution[0]} rows do not split into {n_band} bands")
            self.spatial = CellGrid(n_view, n_band, group if group is not None else default_group())
        self.group = self.spatial.group if self.spatial is not None else None
        self.allreduce_seconds = 0.0  # the last step's gradient average
        g = geometry.cfg
        half = 0.5 * g.scale * np.asarray(g.boxscale, np.float64)
        self.aabb_min, self.aabb_size = tuple((-half).tolist()), tuple((2 * half).tolist())

    def init_state(self, draws, pretrain_steps: int = 1000) -> TrainState:
        params_geo = self.geo.init_params(draws.child("geo"))
        if self.geo.cfg.use_sdf_mlp and pretrain_steps > 0:
            params_geo = self.geo.pretrain_sdf(params_geo, draws.child("pretrain"), steps=pretrain_steps)
        params_mat = init_mlp_texture(draws.child("mat"), self.mat_cfg, self.device)
        light_base = draws.uniform("light", (512, 512, 3)).to(self.device) * 0.5 + 0.25
        return self.make_state(params_geo, params_mat, light_base)

    def make_state(self, params_geo: dict, params_mat: dict, light_base, step: int = 0) -> TrainState:
        """Wrap parameters (made leaf tensors that require grad) with fresh
        optimizers and schedules."""
        def leaf(t):
            return t.detach().clone().to(self.device).requires_grad_(True)

        unknown = set(params_geo) - set(GEO_LR_SCALE)
        if unknown:
            raise ValueError(f"no optimizer group for the geometry parameters {sorted(unknown)}")
        params_geo = {k: {n: [leaf(t) for t in v] for n, v in params_geo[k].items()} if k.endswith("_net")
                      else leaf(params_geo[k]) for k in GEO_LR_SCALE if k in params_geo}
        params_mat = {"tables": leaf(params_mat["tables"]), "mlp": [leaf(w) for w in params_mat["mlp"]]}
        light_base = leaf(light_base)
        broadcast_parameters(_leaves((params_geo, params_mat, [light_base])), self.group)
        t = self.tcfg
        msdf_scale = MSDF_MLP_LR_SCALE if self.geo.cfg.use_msdf_mlp else 1.0
        lr = lambda k: t.lr_pos * (msdf_scale if k.startswith("msdf") else GEO_LR_SCALE[k])
        opt_geo = torch.optim.Adam([{"params": _leaves(v), "lr": lr(k)} for k, v in params_geo.items()], eps=1e-8)
        opt_mat = torch.optim.Adam(_leaves(params_mat), lr=t.lr_mat, eps=1e-8)
        opt_lgt = torch.optim.Adam([light_base], lr=self.lr_lgt, eps=1e-8)
        opts = (opt_geo, opt_mat, opt_lgt)
        scheds = tuple(torch.optim.lr_scheduler.LambdaLR(o, lr_factor) for o in opts)
        return TrainState(params_geo, params_mat, light_base, opts, scheds, step)

    def train_step(self, state: TrainState, draws, target: dict) -> dict:
        """One optimization step, in place on ``state``; returns the metrics
        (0-d tensors)."""
        t = self.tcfg
        it = state.step
        shadow_scale = min(it / t.shadow_ramp_iters, 1.0)
        denoiser_sigma = max(shadow_scale * 2.0, 1e-4)
        light = update_pdf(state.light_base)
        visibility = self.sdf_occluder(state.params_geo) if t.use_shadows and t.shadow_source == "sdf" else None
        img_loss, depth_loss, reg_loss, aux = self.geo.tick(
            draws, state.params_geo, state.params_mat, self.mat_cfg, light, target, it,
            self.flags, self.image_loss_fn, use_shadows=t.use_shadows,
            shadow_scale=shadow_scale, denoiser_sigma=denoiser_sigma, shadow_ko=t.shadow_ko,
            visibility=visibility, spatial=self.spatial,
        )
        total = img_loss + depth_loss + reg_loss
        for opt in state.optimizers:
            opt.zero_grad(set_to_none=True)
        total.backward()
        groups = (state.params_geo, state.params_mat, [state.light_base])
        self.allreduce_seconds = average_gradients(_leaves(groups), self.group)

        # Non-finite gradients (grazing rays, degenerate silhouettes) are
        # zeroed instead of poisoning the Adam moments, and counted.
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for p in (p for g in groups for p in _leaves(g)):
                if p.grad is None:  # an unused parameter gets a zero gradient, as in optax
                    p.grad = torch.zeros_like(p)
                finite = torch.isfinite(p.grad)
                bad += (~finite).sum()
                p.grad.copy_(torch.where(finite, p.grad, 0.0))
            # the SDF MLP's whole gradient, as it reaches Adam
            sdf_norm = {} if "sdf_net" not in state.params_geo else {"sdf_net_grad_norm": torch.linalg.vector_norm(
                torch.cat([p.grad.reshape(-1) for p in _leaves(state.params_geo["sdf_net"])]))}
            state.params_mat["tables"].grad.mul_(1.0 / 8.0)
            state.light_base.grad.mul_(64.0)
        for opt, sched in zip(state.optimizers, state.schedulers):
            opt.step()
            sched.step()
        self.geo.clamp_params(state.params_geo)
        with torch.no_grad():
            state.light_base.clamp_(min=1e-4)
        state.step = it + 1
        return mean_metrics({
            "total": total.detach(),
            "img_loss": img_loss.detach(),
            "depth_loss": depth_loss.detach(),
            "reg_loss": reg_loss.detach(),
            "nonfinite_grads": bad,
            **sdf_norm,
            **{k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()},
        }, self.group)


    def sdf_occluder(self, params_geo: dict):
        """The legacy template-SDF occluder of ``shadow_source`` "sdf": the
        negated lattice SDF (occupied inside, where the SDF is negative) over
        the lattice box, swept into a shadow field or handed to the marcher
        by ``shadow_method``."""
        occ = -self.geo.sdf_lattice(params_geo)
        if self.tcfg.shadow_method == "field":
            return make_shadow_field(occ, self.aabb_min, self.aabb_size, ko=self.tcfg.shadow_ko)
        return make_sdf_visibility(occ, self.aabb_min, self.aabb_size)


def save_state(state: TrainState, draws, path: str, **extra) -> None:
    """Snapshot for ``load_state``: parameters, the three Adam states and
    their schedules, the step, the state of ``draws``' generator, and
    ``extra`` (small picklable values such as a data stream's state).
    Written to a temporary file and moved over ``path``, so a run killed
    mid-save leaves the previous snapshot whole."""
    record = {
        "params_geo": state.params_geo, "params_mat": state.params_mat,
        "light_base": state.light_base,
        "optimizers": [o.state_dict() for o in state.optimizers],
        "schedulers": [s.state_dict() for s in state.schedulers],
        "step": state.step, "draws": draws.gen.get_state(), "extra": extra,
    }
    tmp = path + ".tmp"
    with torch.no_grad():
        torch.save(record, tmp)
    os.replace(tmp, path)


def load_state(rec: Reconstructor, path: str, draws=None):
    """→ (TrainState on ``rec``'s device, the ``extra`` saved with it); sets
    ``draws``' generator to where the snapshot left it, when given."""
    record = torch.load(path, map_location="cpu", weights_only=True)
    state = rec.make_state(record["params_geo"], record["params_mat"], record["light_base"],
                           step=int(record["step"]))
    for obj, sd in zip(state.optimizers + state.schedulers, record["optimizers"] + record["schedulers"]):
        obj.load_state_dict(sd)
    if draws is not None:
        draws.gen.set_state(record["draws"])
    return state, record["extra"]
