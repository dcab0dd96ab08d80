"""Trainable G-Shell FlexiCubes geometry (PyTorch twin of
``gshell_tpu/geometry/flexi_geometry.py``).

The interface of :class:`~gshell_tpu_torch.geometry.geometry.GShellGeometry`
over a voxel grid: per-cube FlexiCubes weights (C, 21) = β (12) ++ α (8) ++
γ (1), zero at init; a deformation of at most a quarter of a voxel; the SDF
(an MLP, or a direct per-vertex field) with gradient on the whole lattice;
a direct mSDF, whatever ``use_msdf_mlp`` says (the JAX geometry keeps a
direct one; the trainer then steps it at lr_pos·1e-2); and the L_dev
regularizer weighted ×0.25 in the loss.  The SDF sign-consistency BCE runs
over every lattice edge.

The tick shadows with the cut mesh it extracted, as the tets tick does (a
surface splat and the swept shadow field); the JAX tick takes whatever
visibility it is handed and cannot build that occluder itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops.mesh_ops import compact_faces
from ..render import regularizer as reg
from ..render.render import RenderFlags
from .cube_grid import build_cube_grid
from .geometry import (CutMesh, GeometryConfig, GShellGeometry, check_view_batch_mode, render_and_score,
                       sdf_weight)
from .gshell_flexicubes import GShellFlexiCubes
from .mlp import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class FlexiGeometryConfig(GeometryConfig):
    grid_res: int = 80  # the voxel grid of configs/deepfashion_mc_80.json
    l_dev_weight: float = 0.25


class GShellFlexiGeometry:
    """Voxel grid + extractor + config; parameters ``{"deform": (N, 3),
    "cube_weights": (C, 21), "msdf": (N,), "sdf_net": {"w": [...], "b": [...]}}``
    (``"sdf"`` (N,) in place of ``"sdf_net"`` for a direct SDF).
    ``max_tets`` / ``max_verts`` of the config, when set, are the surface
    cube and crossing edge capacities, as in the JAX package."""

    def __init__(self, cfg: FlexiGeometryConfig, device):
        check_view_batch_mode(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = build_cube_grid(cfg.grid_res)
        self.extractor = GShellFlexiCubes(self.grid, self.device, cfg.max_tets, cfg.max_verts)
        boxscale = np.asarray(cfg.boxscale, np.float32)
        base = self.grid.verts - self.grid.verts.mean(axis=0)
        self.verts = torch.as_tensor(base * cfg.scale * boxscale, device=self.device)
        self.boxscale = torch.as_tensor(boxscale, device=self.device)
        self.max_displacement = (cfg.scale / cfg.grid_res) / 4.0
        self.grid_edges = torch.as_tensor(self.grid.edges, dtype=torch.int64, device=self.device)
        # the tick rasterizes the first 4·max_edges valid faces of the cut
        # mesh (which has 8·max_edges slots), as the JAX tick does
        self.face_cap = 4 * self.extractor.max_edges

    # ---------------- parameters ----------------
    def init_params(self, draws) -> dict:
        n, c = self.grid.n_verts, self.grid.n_cubes
        params = {
            "deform": torch.zeros((n, 3), device=self.device),
            "cube_weights": torch.zeros((c, 21), device=self.device),
            "msdf": torch.clamp(draws.uniform("msdf", (n,)) - 0.01, -1.0, 1.0).to(self.device),
        }
        if self.cfg.use_sdf_mlp:
            params["sdf_net"] = init_mlp(draws.child("sdf_net"), self.cfg.mlp, self.device)
        else:  # the sphere of radius 0.5, inside < 0
            params["sdf"] = torch.linalg.norm(self.verts / self.boxscale, dim=-1) - 0.5
        return params

    def pretrain_sdf(self, params: dict, draws=None, steps: int = 1000, lr: float = 1e-3) -> dict:
        """Fit the SDF MLP to a sphere of radius ``sphere_init_norm`` (inside <
        0) on every lattice vertex, full batch, with Adam; takes no draws.  A
        direct SDF starts as that sphere and is returned as it is."""
        if not self.cfg.use_sdf_mlp:
            return params
        net = {k: [t.detach().clone().requires_grad_(True) for t in v] for k, v in params["sdf_net"].items()}
        opt = torch.optim.Adam(net["w"] + net["b"], lr=lr, eps=1e-8)
        target = torch.linalg.norm(self.verts / self.boxscale, dim=-1, keepdim=True) - self.cfg.sphere_init_norm
        for _ in range(steps):
            loss = torch.mean((apply_mlp(net, self.verts, self.cfg.mlp) - target) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return {**params, "sdf_net": {k: [t.detach() for t in v] for k, v in net.items()}}

    # ---------------- fields and extraction ----------------
    def fields(self, params: dict):
        """(v_deformed, sdf, msdf) on the whole lattice, with gradients."""
        v_def = self.verts + self.max_displacement * params["deform"]
        sdf = params["sdf"] if "sdf" in params else apply_mlp(params["sdf_net"], v_def, self.cfg.mlp)[:, 0]
        return v_def, sdf, params["msdf"]

    def extract(self, params: dict, training: bool = True):
        """→ (FlexiMesh, sdf on the lattice, faces compacted to the front of
        ``face_cap`` slots, their validity, the count of valid faces)."""
        v_def, sdf, msdf = self.fields(params)
        w = params["cube_weights"]
        mesh = self.extractor(v_def, sdf, msdf, beta=w[:, :12], alpha=w[:, 12:20], gamma=w[:, 20],
                              training=training)
        faces_c, fvalid_c, n_faces = compact_faces(mesh.faces, mesh.face_valid, cap=self.face_cap)
        return mesh, sdf, faces_c, fvalid_c, n_faces

    @torch.no_grad()
    def get_mesh(self, params: dict, training: bool = True) -> CutMesh:
        """The cut mesh without gradients, faces compacted to the front (the
        training split by default, as the JAX package's ``get_mesh``)."""
        mesh, _, faces_c, fvalid_c, n_faces = self.extract(params, training)
        return CutMesh(mesh.verts, faces_c, fvalid_c, n_faces, mesh.v_nrm, mesh.msdf)

    @torch.no_grad()
    def clamp_params(self, params: dict) -> None:
        """Post-step clamps, in place."""
        params["deform"].clamp_(-1.0, 1.0)
        params["msdf"].clamp_(-2.0, 2.0)

    @torch.no_grad()
    def sdf_lattice(self, params: dict):
        """The SDF as an (R+1)³ volume, inside > 0 (FlexiCubes' field negated)."""
        r = self.cfg.grid_res + 1
        return (-self.fields(params)[1]).reshape(r, r, r)

    splat_occupancy = GShellGeometry.splat_occupancy

    # ---------------- losses ----------------
    def tick(self, draws, params: dict, mat_params: dict, mat_cfg, light, target: dict,
             iteration: int, flags: RenderFlags, image_loss_fn: Callable,
             use_shadows: bool = True, shadow_scale: float = 1.0,
             denoiser_sigma: float = 2.0, shadow_ko: int = 16, visibility=None, spatial=None):
        """One training evaluation → (img_loss, depth_loss, reg_loss, aux): the
        tets tick's terms, the SDF BCE over every lattice edge, and
        ``l_dev_weight``·L_dev.  Views render one after another, each
        recomputed in the backward under ``view_batch_mode`` "map_remat", as
        in the tets tick (JAX's FlexiCubes tick always recomputes).
        ``visibility``, where given, replaces the cut mesh's splat.  With
        ``spatial`` (a ``parallel.spatial.CellGrid``) the views render in
        (view, band) cells over its ranks; the extraction stays replicated
        (JAX's FlexiCubes extractor has no sharded form)."""
        mesh, sdf, faces_c, fvalid_c, n_faces = self.extract(params)
        img_loss, depth_loss, terms, aux = render_and_score(
            self, draws, params, mesh, faces_c, fvalid_c, mesh.v_nrm, mat_params, mat_cfg, light, target,
            iteration, flags, image_loss_fn, use_shadows, shadow_scale, denoiser_sigma, shadow_ko,
            remat=self.cfg.view_batch_mode == "map_remat", visibility=visibility, spatial=spatial)
        sdf_reg = reg.sdf_reg_loss(sdf, self.grid_edges) * sdf_weight(self.cfg, iteration)
        reg_loss = (sdf_reg + terms["eik_loss"] + terms["msdf_reg"] + terms["shading_reg"]
                    + self.cfg.l_dev_weight * mesh.l_dev)
        ext = self.extractor
        aux = {
            "n_surf_cubes": mesh.n_surf_cubes,
            "n_faces": n_faces,
            "n_crossing_edges": mesh.n_crossing_edges,
            # a count above its slots is truncated by the compaction
            "cube_slot_overflow": (mesh.n_surf_cubes > ext.max_cubes).to(torch.int32),
            "edge_slot_overflow": (mesh.n_quad_edges > ext.max_edges).to(torch.int32),
            "face_cap_overflow": (n_faces > self.face_cap).to(torch.int32),
            "l_dev": mesh.l_dev,
            "sdf_reg": sdf_reg,
            **terms, **aux,
        }
        return img_loss, depth_loss, reg_loss, aux
