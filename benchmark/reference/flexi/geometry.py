"""Trainable G-Shell FlexiCubes geometry, the plain reference: a frozen copy
of the port's ``geometry/flexi_geometry.py`` for one process.

The interface of ``recon/geometry/geometry.GShellGeometry`` over a voxel
grid: per-cube FlexiCubes weights (C, 21) = β (12) ++ α (8) ++ γ (1); a
deformation of at most a quarter of a voxel (upstream's
``gshell_flexicubes_geometry.py:117`` takes a quarter of the mean edge
length, the same on a regular grid); the SDF MLP with gradient on the whole
lattice; a direct mSDF; the L_dev regularizer weighted ×0.25 in the loss
(upstream ``:358``).  The SDF sign-consistency BCE runs over every lattice
edge.  Everything the tick shares with marching tets (the shadow splat,
each view's render under ``map_remat``, the image, mSDF, eikonal and
shading terms) is ``recon/geometry/geometry.render_and_score``, imported.

Departures from upstream, each the port's: the tick shadows with a splat of
the cut mesh it extracted, swept into a shadow field (upstream traces an
OptiX BVH of the mesh); the rasterizer sees the first ``4·max_edges`` valid
faces of the cut mesh (``face_cap``), which the caller reports when the cut
has more; the initial parameters and the pretrain are the benchmark's
inputs, not copied here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..recon.geometry.geometry import (GeometryConfig, GShellGeometry, check_view_batch_mode,
                                       render_and_score, sdf_weight)
from ..recon.geometry.mlp import apply_mlp
from ..recon.ops.mesh_ops import compact_faces
from ..recon.render import regularizer as reg
from ..recon.render.render import RenderFlags
from .cube_grid import build_cube_grid
from .gshell_flexicubes import GShellFlexiCubes


@dataclasses.dataclass(frozen=True)
class FlexiGeometryConfig(GeometryConfig):
    grid_res: int = 80
    l_dev_weight: float = 0.25


class GShellFlexiGeometry:
    """Voxel grid + extractor + config; parameters ``{"deform": (N, 3),
    "cube_weights": (C, 21), "msdf": (N,), "sdf_net": {"w": [...], "b": [...]}}``.
    ``max_tets`` / ``max_verts`` of the config, when set, are the surface
    cube and crossing edge capacities."""

    def __init__(self, cfg: FlexiGeometryConfig, device):
        check_view_batch_mode(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = build_cube_grid(cfg.grid_res)
        self.extractor = GShellFlexiCubes(self.grid, self.device, cfg.max_tets, cfg.max_verts)
        boxscale = np.asarray(cfg.boxscale, np.float32)
        base = self.grid.verts - self.grid.verts.mean(axis=0)
        self.verts = torch.as_tensor(base * cfg.scale * boxscale, device=self.device)
        self.max_displacement = (cfg.scale / cfg.grid_res) / 4.0
        self.grid_edges = torch.as_tensor(self.grid.edges, dtype=torch.int64, device=self.device)
        self.face_cap = 4 * self.extractor.max_edges

    def fields(self, params: dict):
        """(v_deformed, sdf, msdf) on the whole lattice, with gradients."""
        v_def = self.verts + self.max_displacement * params["deform"]
        return v_def, apply_mlp(params["sdf_net"], v_def, self.cfg.mlp)[:, 0], params["msdf"]

    def extract(self, params: dict):
        """→ (FlexiMesh, sdf on the lattice, faces compacted to the front of
        ``face_cap`` slots, their validity, the count of valid faces)."""
        v_def, sdf, msdf = self.fields(params)
        w = params["cube_weights"]
        mesh = self.extractor(v_def, sdf, msdf, beta=w[:, :12], alpha=w[:, 12:20], gamma=w[:, 20], training=True)
        faces_c, fvalid_c, n_faces = compact_faces(mesh.faces, mesh.face_valid, cap=self.face_cap)
        return mesh, sdf, faces_c, fvalid_c, n_faces

    @torch.no_grad()
    def clamp_params(self, params: dict) -> None:
        params["deform"].clamp_(-1.0, 1.0)
        params["msdf"].clamp_(-2.0, 2.0)

    splat_occupancy = GShellGeometry.splat_occupancy

    def tick(self, draws, params: dict, mat_params: dict, mat_cfg, light, target: dict,
             iteration: int, flags: RenderFlags, image_loss_fn: Callable,
             use_shadows: bool = True, shadow_scale: float = 1.0,
             denoiser_sigma: float = 2.0, shadow_ko: int = 16):
        """One training evaluation → (img_loss, depth_loss, reg_loss, aux)."""
        mesh, sdf, faces_c, fvalid_c, n_faces = self.extract(params)
        img_loss, depth_loss, terms, aux = render_and_score(
            self, draws, params, mesh, faces_c, fvalid_c, mesh.v_nrm, mat_params, mat_cfg, light, target,
            iteration, flags, image_loss_fn, use_shadows, shadow_scale, denoiser_sigma, shadow_ko,
            remat=self.cfg.view_batch_mode == "map_remat")
        sdf_reg = reg.sdf_reg_loss(sdf, self.grid_edges) * sdf_weight(self.cfg, iteration)
        reg_loss = (sdf_reg + terms["eik_loss"] + terms["msdf_reg"] + terms["shading_reg"]
                    + self.cfg.l_dev_weight * mesh.l_dev)
        aux = {"n_surf_cubes": mesh.n_surf_cubes, "n_faces": n_faces, "n_quad_edges": mesh.n_quad_edges,
               "l_dev": mesh.l_dev, "sdf_reg": sdf_reg, **terms, **aux}
        return img_loss, depth_loss, reg_loss, aux
