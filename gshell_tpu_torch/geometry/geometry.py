"""Trainable G-Shell geometry: parameters, extraction and the training loss
(PyTorch twin of ``gshell_tpu/geometry/geometry.py``).  The SDF and the
mSDF are each a direct per-vertex field or an MLP.  With an MLP and
``lazy_field_grad`` the lattice field is evaluated without gradient (the
extractor reads only its signs) and the MLP again at the crossing-edge
endpoints, where the values carry gradients; otherwise the fields carry
gradients on the whole lattice.

``tick`` assembles the reference loss: image + mask loss, mSDF image hinges,
the second layer's image loss and the depth terms when the config asks for
them, eikonal on surface samples (SDF MLP only), mSDF open/close
regularizers, the annealed SDF sign-consistency BCE (over the crossing-edge
slots on the lazy path, over every lattice edge otherwise), and the
shading / material regularizers."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.mesh_ops import auto_normals, compact_faces, sample_surface
from ..ops.shade import make_shadow_field, splat_lattice
from ..parallel.spatial import CellGrid, render_batch_banded
from ..render import regularizer as reg
from ..render.render import RenderFlags, render_mesh, render_second_layer
from ..utils.spans import span
from .gshell_tets import GShellTets
from .mlp import MLPConfig, apply_mlp, init_mlp
from .tet_grid import build_tet_grid, default_capacities


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    grid_res: int = 64
    scale: float = 1.4
    boxscale: tuple = (1.0, 1.0, 1.0)
    mlp: MLPConfig = MLPConfig(n_freq=6, d_hidden=256, n_hidden=6, skip_in=(3,))
    use_sdf_mlp: bool = True
    use_msdf_mlp: bool = False
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
    # depth and second-layer supervision (the reference's FLAGS use_depth,
    # use_img_2nd_layer, use_depth_2nd_layer)
    use_depth: bool = False
    use_img_2nd_layer: bool = False
    use_depth_2nd_layer: bool = False
    total_iters: int = 5000
    # how a batch of views renders: one after another, each view's render
    # recomputed in the backward ("map_remat") or its residuals kept ("map";
    # "vmap" is the same loop), in both ticks (JAX's FlexiCubes tick always
    # recomputes)
    view_batch_mode: str = "map_remat"
    # MLP fields: evaluate the lattice field without gradient and the MLP
    # again at the crossing-edge endpoints (JAX's default)
    lazy_field_grad: bool = True
    capacity_safety: float = 1.0
    max_tets: Optional[int] = None
    max_verts: Optional[int] = None
    # under a banded render over a process group, split the extractor's
    # per-slot stages over the ranks (outputs replicated by a stitch)
    shard_extraction: bool = True


class CutMesh(NamedTuple):
    """An extracted cut mesh: faces compacted to the front of a max_tets
    buffer, ``face_valid`` marking the first ``n_faces``."""
    verts: torch.Tensor
    faces: torch.Tensor
    face_valid: torch.Tensor
    n_faces: torch.Tensor
    v_nrm: torch.Tensor
    msdf: torch.Tensor


class GShellGeometry:
    """Static lattice + extractor + config; parameters live in plain dicts
    ``{"deform": (N, 3), "msdf": (N,), "sdf_net": {"w": [...], "b": [...]}}``
    (``"sdf"`` (N,) in place of ``"sdf_net"`` for a direct SDF,
    ``"msdf_net"`` in place of ``"msdf"`` for an mSDF MLP)."""

    _FIELD_CHUNK = 1 << 19

    def __init__(self, cfg: GeometryConfig, device):
        check_view_batch_mode(cfg)
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
        params = {"deform": torch.zeros((n, 3), device=self.device)}
        # the direct mSDF is drawn before the SDF MLP: a generator-backed
        # source hands out numbers in call order, and seeded states depend on it
        if not self.cfg.use_msdf_mlp:
            params["msdf"] = torch.clamp(draws.uniform("msdf", (n,)) - 0.01, -1.0, 1.0).to(self.device)
        if self.cfg.use_sdf_mlp:
            params["sdf_net"] = init_mlp(draws.child("sdf_net"), self.cfg.mlp, self.device)
        else:
            params["sdf"] = torch.linalg.norm(self.lattice_verts() / self.boxscale, dim=-1) - 0.5
        if self.cfg.use_msdf_mlp:
            params["msdf_net"] = init_mlp(draws.child("msdf_net"), self.cfg.mlp, self.device)
        return params

    def pretrain_sdf(self, params: dict, draws, steps: int = 1000, lr: float = 1e-3) -> dict:
        """Fit the SDF MLP to a sphere of radius ``sphere_init_norm`` on random
        points in the lattice box (Adam, as the reference's sphere init); a
        direct SDF starts as that sphere and is returned as it is."""
        if not self.cfg.use_sdf_mlp:
            return params
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

    def _field(self, params: dict, name: str, pts):
        """A direct field ``params[name]`` or its MLP ``params[name + "_net"]``
        evaluated at ``pts`` in row chunks."""
        if name in params:
            return params[name]
        net = params[f"{name}_net"]
        return torch.cat([apply_mlp(net, pts[i:i + self._FIELD_CHUNK], self.cfg.mlp)[:, 0]
                          for i in range(0, pts.shape[0], self._FIELD_CHUNK)])

    def fields(self, params: dict):
        """(v_deformed, sdf, msdf) on the whole lattice, with gradients, for
        every combination of a direct or an MLP SDF and mSDF."""
        v_def = self.lattice_verts() + self.max_displacement * params["deform"]
        return v_def, self._field(params, "sdf", v_def), self._field(params, "msdf", v_def)

    def fields_lazy(self, params: dict):
        """(v_def, sdf, msdf, sdf_fn, msdf_fn): an MLP field on the lattice
        without gradient (the extractor reads only its signs) and the MLP as
        ``*_fn``, which the extractor calls where values matter; a direct
        field as it is, its ``*_fn`` None."""
        v_def = self.lattice_verts() + self.max_displacement * params["deform"]
        out, fns = [], []
        for name in ("sdf", "msdf"):
            if name in params:
                out.append(params[name])
                fns.append(None)
                continue
            with torch.no_grad():
                out.append(self._field(params, name, v_def.detach()))
            net = params[f"{name}_net"]
            fns.append(lambda p, net=net: apply_mlp(net, p, self.cfg.mlp)[:, 0])
        return v_def, out[0], out[1], fns[0], fns[1]

    @torch.no_grad()
    def sdf_lattice(self, params: dict):
        """The SDF as an (R+1)³ volume, inside negative (the sphere init's
        sign): a shadow occluder is its negation, occupied where > 0."""
        r = self.cfg.grid_res + 1
        return self.fields(params)[1].reshape(r, r, r)

    def splat_occupancy(self, draws, verts, faces, face_valid, res: int = 65,
                        n_samples: int = 1 << 17):
        """0/1 occupancy lattice of the cut surface over the geometry box →
        (occ, aabb_min, aabb_size, coverage), ``coverage`` as
        :func:`splat_lattice` reports it for the fixed sample count."""
        half = 0.5 * self.cfg.scale * np.asarray(self.cfg.boxscale, np.float32)
        with torch.no_grad():
            pts = sample_surface(draws, verts.detach(), faces, n_samples, face_mask=face_valid)
            occ, coverage = splat_lattice(pts, -half, 2 * half, res)
        return occ, tuple((-half).tolist()), tuple((2 * half).tolist()), coverage

    @torch.no_grad()
    def clamp_params(self, params: dict) -> None:
        """Post-step clamps, in place."""
        params["deform"].clamp_(-1.0, 1.0)
        if "msdf" in params:
            params["msdf"].clamp_(-2.0, 2.0)

    def extract(self, params: dict, shard_group=None):
        """Cut mesh with its faces compacted to the front of a max_tets
        buffer → (mesh, faces, face_valid, n_faces, smooth vertex normals,
        the lattice SDF the extractor read: without gradient on the lazy
        path, with it otherwise).  ``shard_group``: the extractor's per-slot
        stages split over its ranks.  Span ``recon.extract``."""
        cfg = self.cfg
        with span("recon.extract"):
            if cfg.lazy_field_grad and (cfg.use_sdf_mlp or cfg.use_msdf_mlp):
                v_def, sdf, msdf, sdf_fn, msdf_fn = self.fields_lazy(params)
            else:
                (v_def, sdf, msdf), sdf_fn, msdf_fn = self.fields(params), None, None
            mesh = self.extractor(v_def, sdf, msdf, sdf_fn=sdf_fn, msdf_fn=msdf_fn, shard_group=shard_group)
            faces_c, fvalid_c, n_faces = compact_faces(mesh.faces, mesh.face_valid, cap=self.extractor.max_tets)
            return mesh, faces_c, fvalid_c, n_faces, auto_normals(mesh.verts, faces_c, fvalid_c), sdf

    @torch.no_grad()
    def get_mesh(self, params: dict) -> CutMesh:
        """The cut mesh without gradients, faces compacted to the front."""
        mesh, faces_c, fvalid_c, n_faces, v_nrm, _ = self.extract(params)
        return CutMesh(mesh.verts, faces_c, fvalid_c, n_faces, v_nrm, mesh.msdf)

    # ---------------- losses ----------------
    def tick(self, draws, params: dict, mat_params: dict, mat_cfg, light, target: dict,
             iteration: int, flags: RenderFlags, image_loss_fn: Callable,
             use_shadows: bool = True, shadow_scale: float = 1.0,
             denoiser_sigma: float = 2.0, shadow_ko: int = 16, visibility=None,
             spatial: Optional[CellGrid] = None):
        """One training evaluation → (img_loss, depth_loss, reg_loss, aux).
        ``target``: 'mvp' (B,4,4), 'campos' (B,3), 'img' (B,H,W,4),
        'background' (B,H,W,3); 'invdepth' (B,H,W,1), 'img_second'
        (B,H,W,4) and 'invdepth_second' (B,H,W,1) for the supervision the
        config turns on.  Views render one after another, each recomputed
        in the backward under ``view_batch_mode`` "map_remat".  Shadows
        come from ``visibility`` where the caller built an occluder (the
        template-SDF sources), else from the cut mesh's splat.  With
        ``spatial`` the views render in (view, band) cells over its ranks
        (``view_batch_mode`` does not apply), and under
        ``shard_extraction`` the extractor's per-slot stages split over
        them too."""
        shard = spatial.group if spatial is not None and self.cfg.shard_extraction else None
        mesh, faces_c, fvalid_c, n_faces, v_nrm, sdf = self.extract(params, shard)
        img_loss, depth_loss, terms, aux = render_and_score(
            self, draws, params, mesh, faces_c, fvalid_c, v_nrm, mat_params, mat_cfg, light, target,
            iteration, flags, image_loss_fn, use_shadows, shadow_scale, denoiser_sigma, shadow_ko,
            remat=self.cfg.view_batch_mode == "map_remat", visibility=visibility, spatial=spatial)
        # on the lazy path the lattice SDF carries no gradient: the BCE reads
        # the crossing-edge slots the extractor re-evaluated (the same edges)
        r1 = self.cfg.grid_res + 1
        lazy_sdf = self.cfg.use_sdf_mlp and self.cfg.lazy_field_grad
        sdf_reg = (reg.sdf_reg_loss_edges(mesh.edge_sdf) if lazy_sdf
                   else reg.sdf_reg_loss_lattice(sdf.reshape(r1, r1, r1))) * sdf_weight(self.cfg, iteration)
        reg_loss = sdf_reg + terms["eik_loss"] + terms["msdf_reg"] + terms["shading_reg"]
        aux = {
            "n_valid_tets": mesh.n_valid_tets,
            "n_faces": n_faces,
            "n_crossing_edges": mesh.n_crossing_edges,
            "tet_slot_overflow": (mesh.n_valid_tets >= self.extractor.max_tets).to(torch.int32),
            "edge_slot_overflow": (mesh.n_crossing_edges >= self.extractor.max_verts).to(torch.int32),
            "sdf_reg": sdf_reg,
            **terms, **aux,
        }
        return img_loss, depth_loss, reg_loss, aux


VIEW_BATCH_MODES = ("map_remat", "map", "vmap")


def check_view_batch_mode(cfg) -> None:
    if cfg.view_batch_mode not in VIEW_BATCH_MODES:
        raise ValueError(f"view_batch_mode {cfg.view_batch_mode!r}: one of {', '.join(VIEW_BATCH_MODES)}")


def sdf_weight(cfg, iteration: int) -> float:
    """The SDF BCE's weight, annealed from ``sdf_regularizer`` to 0.01 over
    the first quarter of the run."""
    return cfg.sdf_regularizer - (cfg.sdf_regularizer - 0.01) * min(1.0, 4.0 * (iteration / cfg.total_iters))


def checkpoint_draws(fn, draws):
    """``fn()`` under a non-reentrant ``torch.utils.checkpoint``: its
    activations are dropped and ``fn`` runs again in the backward.  Its
    random draws replay: a generator-backed ``draws`` is put back to the
    state it had before ``fn`` for the recomputation, then to where the
    recomputation found it, so the recomputed forward draws the same
    numbers and later draws do not shift.  (``checkpoint``'s own RNG
    preservation covers the global generators only, not an explicit one.)"""
    gen = getattr(draws, "gen", None)
    if gen is None:  # ReplayDraws: the same numbers by name on every call
        return checkpoint(fn, use_reentrant=False, preserve_rng_state=False)
    start, calls = gen.get_state(), [0]

    def run():
        calls[0] += 1
        if calls[0] == 1:
            return fn()
        now = gen.get_state()
        gen.set_state(start)
        try:
            return fn()
        finally:
            gen.set_state(now)

    return checkpoint(run, use_reentrant=False, preserve_rng_state=False)


def render_and_score(geo, draws, params: dict, mesh, faces_c, fvalid_c, v_nrm, mat_params: dict, mat_cfg,
                     light, target: dict, iteration: int, flags: RenderFlags, image_loss_fn: Callable,
                     use_shadows: bool, shadow_scale: float, denoiser_sigma: float, shadow_ko: int,
                     remat: bool = False, visibility=None, spatial: Optional[CellGrid] = None):
    """What the tets and the FlexiCubes ticks share: the shadow field of the
    cut mesh's splat (draws ``splat``), every view's render (``view{b}``;
    its second layer, when the config's ``use_img_2nd_layer`` or
    ``use_depth_2nd_layer`` asks for it, ``view{b}/second``), under
    :func:`checkpoint_draws` when ``remat`` and there is more than one view,
    the image, mask, mSDF-image, second-layer image and depth losses, the
    eikonal on surface samples (``eik``; with an SDF MLP), the mSDF open / close
    regularizers and the shading ones.  ``mesh`` has ``verts``, ``msdf``,
    ``msdf_boundary`` and ``n_verts_watertight``.  → (img_loss, depth_loss,
    {eik_loss, msdf_reg, shading_reg}, {raster_dropped, px_dropped, splat
    coverage}).  A ``visibility`` the caller built takes the splat's place.
    With ``spatial`` the views render in (view, band) cells
    (:func:`parallel.spatial.render_batch_banded`; cell (v, b) draws under
    ``view{v}/band{b}``, with no recomputation whatever ``remat`` says).
    Span ``recon.shadow`` around the splat and its shadow field."""
    cfg, dev = geo.cfg, geo.device
    coverage = {}
    if use_shadows and visibility is None:
        with span("recon.shadow"):
            occ, amin, asz, coverage = geo.splat_occupancy(draws.child("splat"), mesh.verts, faces_c, fvalid_c)
            visibility = make_shadow_field(occ, amin, asz, ko=shadow_ko)
    second = cfg.use_img_2nd_layer or cfg.use_depth_2nd_layer
    n_views = target["mvp"].shape[0]

    def render_view(vd, mvp, campos, bg, flags_):
        buf = render_mesh(vd, mesh.verts, faces_c, v_nrm, mesh.msdf, mat_params, mat_cfg, mvp, campos, light,
                          flags_, background=bg, visibility=visibility, shadow_scale=shadow_scale,
                          denoiser_sigma=denoiser_sigma, n_layers=2 if second else 1)
        if second:
            buf.update(render_second_layer(vd.child("second"), mesh.verts, faces_c, v_nrm, mat_params, mat_cfg,
                                           mvp, campos, light, flags_, background=bg, visibility=visibility,
                                           shadow_scale=shadow_scale, rast2=buf.pop("rast_second")))
        return buf

    def render(b):
        return render_view(draws.child(f"view{b}"), target["mvp"][b], target["campos"][b],
                           target["background"][b], flags)

    if spatial is not None:
        buffers = render_batch_banded(
            lambda cd, mvp, campos, bg, res: render_view(cd, mvp, campos, bg, flags._replace(resolution=res)),
            draws, target["mvp"], target["campos"], target["background"], flags.resolution, spatial)
    else:
        if remat and n_views > 1:
            views = [checkpoint_draws(lambda b=b: render(b), draws) for b in range(n_views)]
        else:
            views = [render(b) for b in range(n_views)]
        buffers = {k: torch.stack([torch.as_tensor(v[k], device=dev) for v in views]) for k in views[0]}

    color_ref = target["img"]
    gt_mask = color_ref[..., 3:]
    shaded = buffers["shaded"]
    img_loss = torch.mean((shaded[..., 3:] - gt_mask) ** 2)
    img_loss = img_loss + image_loss_fn(shaded[..., 0:3] * gt_mask, color_ref[..., 0:3] * gt_mask)
    msdf_img = buffers["msdf_image"]
    img_loss = img_loss + 5e-1 * torch.mean(torch.abs(torch.clamp(msdf_img, min=0.0) * (gt_mask == 0)))
    img_loss = img_loss + 5e-1 * torch.mean(
        torch.abs(torch.clamp(msdf_img, max=0.0) * (gt_mask == 1) - 1.0))
    img_extra, depth_loss = reg.second_layer_and_depth_losses(cfg, buffers, target, image_loss_fn)
    img_loss = img_loss + img_extra

    eik_loss = torch.zeros((), device=dev)
    if cfg.use_sdf_mlp and cfg.use_eikonal:
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

    msdf_reg = torch.zeros((), device=dev)
    if cfg.msdf_reg_open_scale > 0:
        d = torch.abs(torch.clamp(mesh.msdf, min=-eps) + eps)
        msdf_reg = msdf_reg + cfg.msdf_reg_open_scale * regscale * huber(d).sum()
    if cfg.msdf_reg_close_scale != 0:
        vis_any = torch.any(buffers["visible_vert_mask"], dim=0)
        vis_boundary = vis_any[mesh.n_verts_watertight:].to(mesh.msdf.dtype)
        d = torch.abs(torch.clamp(mesh.msdf_boundary, max=eps) - eps)
        msdf_reg = msdf_reg + cfg.msdf_reg_close_scale * regscale * torch.sum(huber(d) * vis_boundary)

    shading_reg = torch.zeros((), device=dev)
    if "diffuse_light" in buffers:  # the normal / kd / ks BSDFs emit no light buffers
        shading_reg = reg.shading_loss(buffers["diffuse_light"], buffers["specular_light"], color_ref,
                                       cfg.lambda_diffuse, cfg.lambda_specular)
    shading_reg = shading_reg + reg.material_smoothness_grad(
        buffers["kd_grad"], buffers["ks_grad"], buffers["normal_grad"],
        lambda_kd=cfg.lambda_kd, lambda_ks=cfg.lambda_ks, lambda_nrm=cfg.lambda_nrm,
    )
    shading_reg = shading_reg + reg.chroma_loss(buffers["kd"], color_ref, cfg.lambda_chroma)
    dropped = lambda k: buffers[k].sum() if k in buffers else 0
    aux = {
        "raster_dropped": dropped("n_raster_dropped"),
        "px_dropped": dropped("n_px_dropped") + dropped("n_px_dropped_second"),
        **coverage,
    }
    return img_loss, depth_loss, {"eik_loss": eik_loss, "msdf_reg": msdf_reg, "shading_reg": shading_reg}, aux
