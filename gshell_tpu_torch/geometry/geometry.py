"""Trainable G-Shell geometry: parameters, extraction and the training loss
(PyTorch twin of ``gshell_tpu/geometry/geometry.py``, MLP-SDF path with
lazy field gradients).

``tick`` assembles the reference loss: image + mask loss, mSDF image hinges,
eikonal on surface samples, mSDF open/close regularizers, the annealed SDF
sign-consistency BCE, and the shading / material regularizers."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.mesh_ops import auto_normals, compact_faces, sample_surface
from ..ops.shade import make_shadow_field
from ..render import regularizer as reg
from ..render.render import RenderFlags, render_mesh
from .gshell_tets import GShellTets
from .mlp import MLPConfig, apply_mlp, init_mlp
from .tet_grid import build_tet_grid, default_capacities


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    grid_res: int = 64
    scale: float = 1.4
    boxscale: tuple = (1.0, 1.0, 1.0)
    mlp: MLPConfig = MLPConfig(n_freq=6, d_hidden=256, n_hidden=6, skip_in=(3,))
    sphere_init_norm: float = 0.5
    msdf_reg_open_scale: float = 1e-6
    msdf_reg_close_scale: float = 3e-6
    sdf_regularizer: float = 0.2
    eikonal_scale: Optional[float] = None
    lambda_kd: float = 0.1
    lambda_ks: float = 0.05
    lambda_nrm: float = 0.025
    lambda_chroma: float = 0.0
    lambda_diffuse: float = 0.15
    lambda_specular: float = 0.0025
    use_eikonal: bool = True
    n_eikonal_samples: int = 50000
    total_iters: int = 5000
    capacity_safety: float = 1.0
    max_tets: Optional[int] = None
    max_verts: Optional[int] = None


class GShellGeometry:
    """Static lattice + extractor + config; parameters live in plain dicts
    ``{"deform": (N, 3), "msdf": (N,), "sdf_net": {"w": [...], "b": [...]}}``."""

    _FIELD_CHUNK = 1 << 19

    def __init__(self, cfg: GeometryConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = build_tet_grid(cfg.grid_res, build_topology=False)
        mt, mv = cfg.max_tets, cfg.max_verts
        if (mt is None or mv is None) and cfg.capacity_safety != 1.0:
            d_t, d_v = default_capacities(
                self.grid.res, self.grid.n_tets, self.grid.n_edges, safety=cfg.capacity_safety
            )
            mt, mv = mt or d_t, mv or d_v
        self.extractor = GShellTets(self.grid, self.device, mt, mv)
        self.boxscale = torch.tensor(cfg.boxscale, dtype=torch.float32, device=self.device)
        self.max_displacement = 1.0 / cfg.grid_res * cfg.scale / 2.1

    # ---------------- parameters ----------------
    def init_params(self, draws) -> dict:
        n = self.grid.n_verts
        msdf = torch.clamp(draws.uniform("msdf", (n,)) - 0.01, -1.0, 1.0)
        return {
            "deform": torch.zeros((n, 3), device=self.device),
            "sdf_net": init_mlp(draws.child("sdf_net"), self.cfg.mlp, self.device),
            "msdf": msdf.to(self.device),
        }

    def pretrain_sdf(self, params: dict, draws, steps: int = 1000, lr: float = 1e-3) -> dict:
        """Fit the SDF MLP to a sphere of radius ``sphere_init_norm`` on random
        points in the lattice box (Adam, as the reference's sphere init)."""
        cfg = self.cfg
        net = {k: [t.detach().clone().requires_grad_(True) for t in v]
               for k, v in params["sdf_net"].items()}
        opt = torch.optim.Adam(net["w"] + net["b"], lr=lr, eps=1e-8)
        n_pts = min(self.grid.n_verts, 1 << 18)
        scale_vec = cfg.scale * self.boxscale
        for i in range(steps):
            verts = draws.uniform(f"step{i}", (n_pts, 3), -0.5, 0.5).to(self.device) * scale_vec
            target = torch.linalg.norm(verts / self.boxscale, dim=-1, keepdim=True) - cfg.sphere_init_norm
            loss = torch.mean((apply_mlp(net, verts, cfg.mlp) - target) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return {**params, "sdf_net": {k: [t.detach() for t in v] for k, v in net.items()}}

    # ---------------- field evaluation ----------------
    def lattice_verts(self):
        n = self.cfg.grid_res + 1
        axis = torch.linspace(-0.5, 0.5, n, dtype=torch.float32, device=self.device)
        axis = axis - axis.mean()
        gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
        base = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
        return base * (self.cfg.scale * self.boxscale)

    def fields_lazy(self, params: dict):
        """(v_def, sdf without gradient, msdf, sdf_fn): the dense SDF gives
        only signs; ``sdf_fn`` re-evaluates the MLP where values matter."""
        v_def = self.lattice_verts() + self.max_displacement * params["deform"]
        net, mcfg = params["sdf_net"], self.cfg.mlp
        with torch.no_grad():
            pts = v_def.detach()
            sdf = torch.cat([
                apply_mlp(net, pts[i:i + self._FIELD_CHUNK], mcfg)[:, 0]
                for i in range(0, pts.shape[0], self._FIELD_CHUNK)
            ])
        return v_def, sdf, params["msdf"], lambda p: apply_mlp(net, p, mcfg)[:, 0]

    def splat_occupancy(self, draws, verts, faces, face_valid, res: int = 65,
                        n_samples: int = 1 << 17):
        """0/1 occupancy lattice of the cut surface over the geometry box."""
        half = 0.5 * self.cfg.scale * np.asarray(self.cfg.boxscale, np.float32)
        amin = torch.as_tensor(-half, device=self.device)
        asz = torch.as_tensor(2 * half, device=self.device)
        with torch.no_grad():
            pts = sample_surface(draws, verts.detach(), faces, n_samples, face_mask=face_valid)
            ijk = torch.clamp(((pts - amin) / asz * (res - 1)).to(torch.int64), 0, res - 1)
            occ = torch.zeros((res, res, res), dtype=torch.float32, device=self.device)
            occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = 1.0
        return occ, tuple((-half).tolist()), tuple((2 * half).tolist())

    @torch.no_grad()
    def clamp_params(self, params: dict) -> None:
        """Post-step clamps, in place."""
        params["deform"].clamp_(-1.0, 1.0)
        params["msdf"].clamp_(-2.0, 2.0)

    def extract(self, params: dict):
        """Cut mesh with its faces compacted to the front of a max_tets
        buffer → (mesh, faces, face_valid, n_faces, smooth vertex normals)."""
        v_def, sdf, msdf, sdf_fn = self.fields_lazy(params)
        mesh = self.extractor(v_def, sdf, msdf, sdf_fn=sdf_fn)
        faces_c, fvalid_c, n_faces = compact_faces(mesh.faces, mesh.face_valid, cap=self.extractor.max_tets)
        return mesh, faces_c, fvalid_c, n_faces, auto_normals(mesh.verts, faces_c, fvalid_c)

    # ---------------- losses ----------------
    def tick(self, draws, params: dict, mat_params: dict, mat_cfg, light, target: dict,
             iteration: int, flags: RenderFlags, image_loss_fn: Callable,
             use_shadows: bool = True, shadow_scale: float = 1.0,
             denoiser_sigma: float = 2.0, shadow_ko: int = 16):
        """One training evaluation → (img_loss, depth_loss, reg_loss, aux).
        ``target``: 'mvp' (B,4,4), 'campos' (B,3), 'img' (B,H,W,4),
        'background' (B,H,W,3).  Views render one after another."""
        cfg = self.cfg
        mesh, faces_c, fvalid_c, n_faces, v_nrm = self.extract(params)

        visibility = None
        if use_shadows:
            occ, amin, asz = self.splat_occupancy(draws.child("splat"), mesh.verts, faces_c, fvalid_c)
            visibility = make_shadow_field(occ, amin, asz, ko=shadow_ko)

        views = [
            render_mesh(
                draws.child(f"view{b}"), mesh.verts, faces_c, v_nrm, mesh.msdf, mat_params,
                mat_cfg, target["mvp"][b], target["campos"][b], light, flags,
                background=target["background"][b], visibility=visibility,
                shadow_scale=shadow_scale, denoiser_sigma=denoiser_sigma,
            )
            for b in range(target["mvp"].shape[0])
        ]
        buffers = {k: torch.stack([v[k] for v in views]) for k in views[0]}

        color_ref = target["img"]
        gt_mask = color_ref[..., 3:]
        shaded = buffers["shaded"]
        img_loss = torch.mean((shaded[..., 3:] - gt_mask) ** 2)
        img_loss = img_loss + image_loss_fn(shaded[..., 0:3] * gt_mask, color_ref[..., 0:3] * gt_mask)
        msdf_img = buffers["msdf_image"]
        img_loss = img_loss + 5e-1 * torch.mean(torch.abs(torch.clamp(msdf_img, min=0.0) * (gt_mask == 0)))
        img_loss = img_loss + 5e-1 * torch.mean(
            torch.abs(torch.clamp(msdf_img, max=0.0) * (gt_mask == 1) - 1.0))
        depth_loss = torch.zeros((), device=self.device)

        eik_loss = torch.zeros((), device=self.device)
        if cfg.use_eikonal:
            pts = sample_surface(draws.child("eik"), mesh.verts.detach(), faces_c,
                                 cfg.n_eikonal_samples, face_mask=fvalid_c)
            if cfg.eikonal_scale is None:
                eik_coeff = 3e-1 if iteration < 500 else (1e-1 if iteration < 2000 else 1e-2)
            else:
                eik_coeff = cfg.eikonal_scale
            pts = pts.detach().requires_grad_(True)
            out = apply_mlp(params["sdf_net"], pts, cfg.mlp)[:, 0]
            (grads,) = torch.autograd.grad(out.sum(), pts, create_graph=True)
            eik_loss = eik_coeff * torch.mean(
                (torch.sqrt(torch.clamp(torch.sum(grads**2, -1), min=1e-12)) - 1.0) ** 2)

        regscale = (64.0 / cfg.grid_res) ** 3
        eps = 1e-3

        def huber(d):
            return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)

        msdf_reg = torch.zeros((), device=self.device)
        if cfg.msdf_reg_open_scale > 0:
            d = torch.abs(torch.clamp(mesh.msdf, min=-eps) + eps)
            msdf_reg = msdf_reg + cfg.msdf_reg_open_scale * regscale * huber(d).sum()
        if cfg.msdf_reg_close_scale != 0:
            vis_any = torch.any(buffers["visible_vert_mask"], dim=0)
            vis_boundary = vis_any[mesh.n_verts_watertight:].to(mesh.msdf.dtype)
            d = torch.abs(torch.clamp(mesh.msdf_boundary, max=eps) - eps)
            msdf_reg = msdf_reg + cfg.msdf_reg_close_scale * regscale * torch.sum(huber(d) * vis_boundary)

        t_iter = iteration / cfg.total_iters
        sdf_weight = cfg.sdf_regularizer - (cfg.sdf_regularizer - 0.01) * min(1.0, 4.0 * t_iter)
        sdf_reg = reg.sdf_reg_loss_edges(mesh.edge_sdf) * sdf_weight

        shading_reg = reg.shading_loss(
            buffers["diffuse_light"], buffers["specular_light"], color_ref,
            cfg.lambda_diffuse, cfg.lambda_specular,
        )
        shading_reg = shading_reg + reg.material_smoothness_grad(
            buffers["kd_grad"], buffers["ks_grad"], buffers["normal_grad"],
            lambda_kd=cfg.lambda_kd, lambda_ks=cfg.lambda_ks, lambda_nrm=cfg.lambda_nrm,
        )
        shading_reg = shading_reg + reg.chroma_loss(buffers["kd"], color_ref, cfg.lambda_chroma)

        reg_loss = sdf_reg + eik_loss + msdf_reg + shading_reg
        aux = {
            "n_valid_tets": mesh.n_valid_tets,
            "n_faces": n_faces,
            "n_crossing_edges": mesh.n_crossing_edges,
            "raster_dropped": torch.stack([torch.as_tensor(v["n_raster_dropped"]) for v in views]).sum(),
            "tet_slot_overflow": (mesh.n_valid_tets >= self.extractor.max_tets).to(torch.int32),
            "edge_slot_overflow": (mesh.n_crossing_edges >= self.extractor.max_verts).to(torch.int32),
            "px_dropped": buffers["n_px_dropped"].sum(),
            "sdf_reg": sdf_reg,
            "eik_loss": eik_loss,
            "msdf_reg": msdf_reg,
            "shading_reg": shading_reg,
        }
        return img_loss, depth_loss, reg_loss, aux
