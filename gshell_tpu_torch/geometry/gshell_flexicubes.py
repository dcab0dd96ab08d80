"""G-Shell FlexiCubes: differentiable Dual Marching Cubes with the mSDF cut,
fixed-capacity slot buffers (PyTorch twin of
``gshell_tpu/geometry/gshell_flexicubes.py``).

Per-cube weights α (8 corners), β (12 edges) and γ (1) steer where each dual
vertex sits and how each quad splits; a second field ν (the mSDF) cuts the
extracted surface open.  Surface cubes and crossing edges are compacted into
fixed-size slots with validity masks, in the JAX package's slot order, and
quads come from the analytic 4-cube adjacency of each interior lattice edge
(``cube_grid``), so the two packages agree slot for slot.

Signs follow the reference: occupancy is ``s < 0`` (the opposite of marching
tets), the mSDF keeps ``ν ≥ 0``, and a quad's winding flips where s at its
edge's low corner is > 0.  Stop-gradients sit where the JAX function puts
them: the mSDF carried by vertices uses detached interpolation and β / γ
weights, so ν is moved only through its own values.

Every gather of a float tensor that carries a gradient is a row gather
(``ops.gather.gather_rows``), whose backward skips the all-zero rows that
the padded slots read from the sentinel rows; on the CPU each one's gradient
is aten's bit for bit.  Tensors gathered by one index are packed into the
columns of one tensor and gathered once, except in the cut: the vertices and
their detached-weight ν are outputs too, and a packed gather would add the
two gathers' gradients together before the output's, in another order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.compact import nonzero_compact
from ..ops.gather import gather_rows
from ..ops.mesh_ops import auto_normals
from . import flexicubes_tables as ft
from .cube_grid import CubeGrid, default_cube_capacities

WEIGHT_SCALE = 0.99


def _edge_to_vd_table() -> np.ndarray:
    """(256, 12) local edge → dual-vertex group index (or -1)."""
    out = np.full((256, 12), -1, np.int64)
    for c in range(256):
        for k in range(4):
            for e in ft.DMC_TABLE[c, k]:
                if e >= 0:
                    out[c, e] = k
    return out


def _columns(a, *widths):
    """Views of the parts of ``a``'s last axis, ``widths`` wide; a part one
    wide loses the axis.  One ``split``, whose backward is one ``cat``."""
    return [p.squeeze(-1) if w == 1 else p for p, w in zip(a.split(widths, dim=-1), widths)]


class FlexiMesh(NamedTuple):
    """Vertex rows: [0, 4·MC) dual vertices | [4·MC] a sentinel zero vertex |
    [4·MC + 1, + ME) quad centres | then 3·(4·ME) boundary vertices."""

    verts: torch.Tensor
    faces: torch.Tensor  # (8·ME, 3) int64 cut faces
    face_valid: torch.Tensor
    v_nrm: torch.Tensor
    msdf: torch.Tensor  # per-vertex ν, interpolated with detached weights
    msdf_boundary: torch.Tensor  # (12·ME,)
    faces_wt: torch.Tensor  # (4·ME, 3) watertight faces before the cut
    face_wt_valid: torch.Tensor
    n_verts_watertight: int
    l_dev: torch.Tensor  # () mean absolute deviation regularizer
    n_surf_cubes: torch.Tensor
    n_crossing_edges: torch.Tensor  # every crossing lattice edge
    n_quad_edges: torch.Tensor  # the interior ones, which take the ME slots


class GShellFlexiCubes:
    """Statically shaped G-Shell FlexiCubes over a :class:`CubeGrid`."""

    def __init__(self, grid: CubeGrid, device, max_cubes: int | None = None,
                 max_edges: int | None = None):
        if max_cubes is None or max_edges is None:
            d_c, d_e = default_cube_capacities(grid.res, grid.n_cubes, grid.n_edges)
            max_cubes = max_cubes or d_c
            max_edges = max_edges or d_e
        self.grid = grid
        self.device = torch.device(device)
        self.max_cubes = int(max_cubes)
        self.max_edges = int(max_edges)

        n, c, e = grid.n_verts, grid.n_cubes, grid.n_edges
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=self.device)
        self.cubes_pad = as_t(np.concatenate([grid.cubes, np.full((1, 8), n)]))
        self.edges_pad = as_t(np.concatenate([grid.edges, np.full((1, 2), n)]))
        adj_c = np.where(grid.edge_adj_cubes < 0, c, grid.edge_adj_cubes)
        self.edge_adj_cubes_pad = as_t(np.concatenate([adj_c, np.full((1, 4), c)]))
        self.edge_adj_local_pad = as_t(np.concatenate([grid.edge_adj_local, np.zeros((1, 4))]))
        self.edge_interior = torch.as_tensor(grid.edge_interior, device=self.device)

        self.dmc_table = as_t(ft.DMC_TABLE)  # (256, 4, 7)
        self.check_table = as_t(ft.CHECK_TABLE)
        self.edge_to_vd = as_t(_edge_to_vd_table())
        self.cube_edge_corners = as_t(ft.CUBE_EDGES)  # (12, 2) local corners
        self.gflex_table = as_t(ft.GFLEX_CONFIGURATION_TABLE)
        self.gflex_num = as_t(ft.GFLEX_NUM_TRIANGLES_TABLE)
        self.quad_split = (as_t(ft.QUAD_SPLIT_1), as_t(ft.QUAD_SPLIT_2))

        r = grid.res
        ids = np.arange(c, dtype=np.int64)
        self.cube_coords = as_t(np.stack([ids // (r * r), (ids // r) % r, ids % r], -1))

    def _arange(self, n):
        return torch.arange(n, dtype=torch.int64, device=self.device)

    def __call__(self, x, s, nu, beta=None, alpha=None, gamma=None, training: bool = True,
                 grad_func=None) -> FlexiMesh:
        """Extract the open-surface mesh.  ``x`` (N, 3) deformed lattice, ``s``
        (N,) SDF (inside < 0), ``nu`` (N,) mSDF; raw weights ``beta`` (C, 12),
        ``alpha`` (C, 8), ``gamma`` (C,).  ``training`` splits each quad into
        four triangles around its γ-weighted centre, else into two along the
        γ-preferred diagonal.  ``grad_func`` (p (..., 3) → SDF gradient)
        places the dual vertices by a QEF."""
        g = self.grid
        C, E = g.n_cubes, g.n_edges
        MC, ME = self.max_cubes, self.max_edges
        r = g.res
        dev, dt = self.device, x.dtype

        x_p = torch.cat([x, torch.zeros((1, 3), dtype=dt, device=dev)])
        s_p = torch.cat([s, torch.ones((1,), dtype=dt, device=dev)])  # the sentinel lies outside
        nu_p = torch.cat([nu, -torch.ones((1,), dtype=dt, device=dev)])
        occ_p = s_p < 0
        xsn_p = torch.cat([x_p, s_p[:, None], nu_p[:, None]], dim=1)  # (N + 1, 5): x, s, ν

        # ---- weights ---------------------------------------------------------
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=dev)
        beta_n = torch.tanh(beta) * WEIGHT_SCALE + 1.0 if beta is not None else ones(C, 12)
        alpha_n = torch.tanh(alpha) * WEIGHT_SCALE + 1.0 if alpha is not None else ones(C, 8)
        gamma_n = (torch.sigmoid(gamma) * WEIGHT_SCALE + (1 - WEIGHT_SCALE) / 2
                   if gamma is not None else ones(C))
        alpha_p = torch.cat([alpha_n, ones(1, 8)])
        beta_gamma_p = torch.cat([torch.cat([beta_n, gamma_n[:, None]], dim=1), ones(1, 13)])  # (C + 1, 13)

        # ---- surface cubes and case ids --------------------------------------
        occ8_all = occ_p[self.cubes_pad[:-1]]  # (C, 8)
        occ_sum = occ8_all.sum(-1)
        surf = (occ_sum > 0) & (occ_sum < 8)
        n_surf = surf.sum()
        pow2 = 2 ** self._arange(8)
        case_all = (occ8_all.to(torch.int64) * pow2).sum(-1)  # (C,)
        # C16/C19 on the full lattice: where this cube and its face neighbour
        # are both flagged, both take the complement case
        chk = self.check_table[case_all]  # (C, 5)
        flagged = (chk[:, 0] == 1) & surf
        adj = self.cube_coords + chk[:, 1:4]
        in_rng = ((adj >= 0) & (adj < r)).all(-1)
        adj_id = torch.clamp((adj[:, 0] * r + adj[:, 1]) * r + adj[:, 2], 0, C - 1)
        invert = flagged & in_rng & flagged[adj_id]
        case_all = torch.where(invert, chk[:, 4], case_all)

        cube_slots = nonzero_compact(surf, MC, C)
        cube_valid = cube_slots < C
        slot_of_cube = torch.full((C + 1,), MC, dtype=torch.int64, device=dev)
        slot_of_cube[cube_slots] = self._arange(MC)
        slot_of_cube[C] = MC
        case_s = torch.where(cube_valid, torch.cat([case_all, case_all.new_zeros(1)])[cube_slots], 0)

        # ---- crossing edges --------------------------------------------------
        e_occ = occ_p[self.edges_pad[:-1]]
        crossing = e_occ[:, 0] != e_occ[:, 1]
        n_cross = crossing.sum()
        quad_ok_all = crossing & self.edge_interior
        edge_slots = nonzero_compact(quad_ok_all, ME, E)
        edge_valid = edge_slots < E

        # ---- dual vertices -----------------------------------------------------
        cube8 = self.cubes_pad[cube_slots]  # (MC, 8)
        ecorn = self.cube_edge_corners
        v_a, v_b = cube8[:, ecorn[:, 0]], cube8[:, ecorn[:, 1]]  # (MC, 12)
        # α of each edge's two corners, from α flattened to rows 8·cube + corner
        alpha_flat, corner0 = alpha_p.reshape(-1), cube_slots[:, None] * 8
        al_a, al_b = gather_rows(alpha_flat, corner0 + ecorn[:, 0]), gather_rows(alpha_flat, corner0 + ecorn[:, 1])
        b12, gam = _columns(gather_rows(beta_gamma_p, cube_slots), 12, 1)  # (MC, 12), (MC,)
        xa, sa, na = _columns(gather_rows(xsn_p, v_a), 3, 1, 1)  # (MC, 12, 3), (MC, 12), (MC, 12)
        xb, sb, nb = _columns(gather_rows(xsn_p, v_b), 3, 1, 1)

        # α-weighted crossing: weights (w_b, -w_a) / (w_b - w_a) on (x_a, x_b)
        wa_c, wb_c = sa * al_a, sb * al_b
        denom = wb_c - wa_c
        dok = (occ_p[v_a] != occ_p[v_b]) & (torch.abs(denom) > 1e-8)
        denom_s = torch.where(dok, denom, 1.0)
        cA = torch.where(dok, wb_c / denom_s, 0.5)
        cB = torch.where(dok, -wa_c / denom_s, 0.5)
        ue = xa * cA[..., None] + xb * cB[..., None]  # (MC, 12, 3)
        nu_e = na * cA + nb * cB
        nu_e_sg = na * cA.detach() + nb * cB.detach()

        groups = self.dmc_table[case_s]  # (MC, 4, 7) local edge ids, -1 padded
        gmask = (groups >= 0) & cube_valid[:, None, None]
        gidx = torch.clamp(groups, 0, 11).reshape(MC, 28)

        def by_group(a):  # (MC, 12, ...) → (MC, 4, 7, ...)
            idx = gidx.reshape(MC, 28, *([1] * (a.ndim - 2))).expand(MC, 28, *a.shape[2:])
            return torch.gather(a, 1, idx).reshape(MC, 4, 7, *a.shape[2:])

        ue_g, nu_g, nu_sg_g = by_group(ue), by_group(nu_e), by_group(nu_e_sg)
        gmask_f = gmask.to(dt)
        beta_g = by_group(b12) * gmask_f  # (MC, 4, 7)
        beta_sum = torch.clamp(beta_g.sum(-1, keepdim=True), min=1e-12)
        vd = (ue_g * beta_g[..., None]).sum(2) / beta_sum  # (MC, 4, 3)
        nu_d = (nu_g * beta_g).sum(-1) / beta_sum[..., 0]
        nu_d_sg = (nu_sg_g * beta_g.detach()).sum(-1) / beta_sum.detach()[..., 0]

        vd_valid = gmask.any(-1)  # (MC, 4)
        if grad_func is not None:
            # QEF: argmin_v Σᵢ (nᵢ·(v − pᵢ))² + qef_reg·‖v − v̄‖² through the
            # 3×3 normal equations of each group (masked rows add nothing),
            # v̄ the β-weighted mean
            qef_reg = 1e-3
            nrm = grad_func(ue_g)
            nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-12)
            am = nrm * gmask_f[..., None]  # (MC, 4, 7, 3)
            bm = (ue_g * am).sum(-1)
            ata = torch.einsum("...ki,...kj->...ij", am, am) + qef_reg * torch.eye(3, dtype=dt, device=dev)
            atb = torch.einsum("...ki,...k->...i", am, bm) + qef_reg * vd
            vd = torch.linalg.solve(ata, atb[..., None])[..., 0]
        vd = torch.where(vd_valid[..., None], vd, 0.0)
        nu_d = torch.where(vd_valid, nu_d, 0.0)
        nu_d_sg = torch.where(vd_valid, nu_d_sg, 0.0)

        # L_dev: mean absolute deviation of |ue − vd| within each group
        dist = torch.linalg.vector_norm(ue_g - vd[:, :, None, :], dim=-1)  # (MC, 4, 7)
        cnt = torch.clamp(gmask_f.sum(-1, keepdim=True), min=1.0)
        mean_l2 = (dist * gmask_f).sum(-1, keepdim=True) / cnt
        mad = torch.abs(dist - mean_l2) * gmask_f
        l_dev = mad.sum() / torch.clamp(gmask_f.sum(), min=1.0)

        # ---- quads from the 4 cubes around each crossing edge ----------------
        adj_slot = slot_of_cube[self.edge_adj_cubes_pad[edge_slots]]  # (ME, 4) ∈ [0, MC]
        adj_local = self.edge_adj_local_pad[edge_slots]
        quad_good = edge_valid & (adj_slot < MC).all(-1)
        adj_slot_c = torch.clamp(adj_slot, 0, MC - 1)
        k_of = self.edge_to_vd[case_s[adj_slot_c], adj_local]  # (ME, 4) ∈ [-1, 4)
        quad_good = quad_good & (k_of >= 0).all(-1)
        quad_vd = adj_slot_c * 4 + torch.clamp(k_of, 0, 3)
        flip = s_p.detach()[self.edges_pad[edge_slots][:, 0]] > 0
        quad = torch.where(flip[:, None], quad_vd[:, [0, 1, 3, 2]], quad_vd[:, [2, 3, 1, 0]])

        n_vd = 4 * MC
        sent = n_vd  # the sentinel zero vertex
        center0 = n_vd + 1
        vd_flat = vd.reshape(n_vd, 3)
        nu_flat = nu_d.reshape(n_vd)
        nu_sg_flat = nu_d_sg.reshape(n_vd)
        gam_vd = gam.repeat_interleave(4)

        # γ-weighted centre of each quad
        qattr = torch.cat([vd_flat, nu_flat[:, None], nu_sg_flat[:, None], gam_vd[:, None]], dim=1)
        qv, qnu, qnu_sg, qg = _columns(gather_rows(qattr, quad), 3, 1, 1, 1)  # (ME, 4, 3), (ME, 4) × 3
        g02, g13 = qg[:, 0] * qg[:, 2], qg[:, 1] * qg[:, 3]
        wsum = g02 + g13 + 1e-8
        center = (((qv[:, 0] + qv[:, 2]) / 2) * g02[:, None] + ((qv[:, 1] + qv[:, 3]) / 2) * g13[:, None]) \
            / wsum[:, None]
        nu_center = (((qnu[:, 0] + qnu[:, 2]) / 2) * g02 + ((qnu[:, 1] + qnu[:, 3]) / 2) * g13) / wsum
        g02_sg, g13_sg, wsum_sg = g02.detach(), g13.detach(), wsum.detach()
        nu_center_sg = (((qnu_sg[:, 0] + qnu_sg[:, 2]) / 2) * g02_sg
                        + ((qnu_sg[:, 1] + qnu_sg[:, 3]) / 2) * g13_sg) / wsum_sg
        center = torch.where(quad_good[:, None], center, 0.0)
        nu_center = torch.where(quad_good, nu_center, 0.0)
        nu_center_sg = torch.where(quad_good, nu_center_sg, 0.0)

        c_ids = center0 + self._arange(ME)
        if training:
            # four triangles (q_j, q_j+1, centre) per quad
            faces_wt = torch.stack([quad, quad[:, [1, 2, 3, 0]], c_ids[:, None].expand(ME, 4)],
                                   dim=-1).reshape(ME * 4, 3)
            face_wt_valid = quad_good.repeat_interleave(4)
        else:
            # two triangles along the γ-preferred diagonal; slots 2-3 padded
            s1 = quad[:, self.quad_split[0]].reshape(ME, 2, 3)
            s2 = quad[:, self.quad_split[1]].reshape(ME, 2, 3)
            two = torch.where((g02 > g13)[:, None, None], s1, s2)
            pad = torch.full((ME, 2, 3), sent, dtype=torch.int64, device=dev)
            faces_wt = torch.cat([two, pad], dim=1).reshape(ME * 4, 3)
            face_wt_valid = torch.cat([quad_good[:, None].expand(ME, 2),
                                       torch.zeros((ME, 2), dtype=torch.bool, device=dev)], dim=1).reshape(-1)
        faces_wt = torch.where(face_wt_valid[:, None], faces_wt, sent)

        zero3 = torch.zeros((1, 3), dtype=dt, device=dev)
        zero1 = torch.zeros((1,), dtype=dt, device=dev)
        verts_wt = torch.cat([vd_flat, zero3, center])
        nu_wt = torch.cat([nu_flat, zero1, nu_center])
        nu_wt_sg = torch.cat([nu_sg_flat, zero1, nu_center_sg])

        # ---- mSDF cut of each triangle ------------------------------------------
        fv = faces_wt
        F = fv.shape[0]
        u_id, w_id = fv, fv[:, [1, 2, 0]]  # the face's edges (0,1), (1,2), (2,0)
        mu_, mw_ = gather_rows(nu_wt, u_id), gather_rows(nu_wt, w_id)  # (F, 3)
        mocc = (mu_ >= 0.0).to(torch.int64)  # ν at the face's corners
        msum = mocc.sum(-1)
        cfg_idx = mocc[:, 0] * 4 + mocc[:, 1] * 2 + mocc[:, 2]
        den = mu_ - mw_
        cut_ok = (torch.abs(den) > 1e-8) & face_wt_valid[:, None]
        den_s = torch.where(cut_ok, den, 1.0)
        bu = torch.where(cut_ok, -mw_ / den_s, 0.0)
        bw = torch.where(cut_ok, mu_ / den_s, 0.0)
        b_verts = gather_rows(verts_wt, u_id) * bu[..., None] + gather_rows(verts_wt, w_id) * bw[..., None]
        b_nu = gather_rows(nu_wt_sg, u_id) * bu.detach() + gather_rows(nu_wt_sg, w_id) * bw.detach()
        b_verts = torch.where(cut_ok[..., None], b_verts, 0.0)
        b_nu = torch.where(cut_ok, b_nu, 0.0)

        b_gid = (center0 + ME) + self._arange(F * 3).reshape(F, 3)
        idx_map6 = torch.cat([fv, b_gid], dim=1)  # (F, 6)
        n_cut = self.gflex_num[cfg_idx]
        trow = torch.clamp(self.gflex_table[cfg_idx], 0, 5)
        cut_faces = torch.gather(idx_map6, 1, trow).reshape(F, 2, 3)
        is_uncut = (msum == 3) & face_wt_valid
        is_cut = (msum > 0) & (msum < 3) & face_wt_valid
        cut_valid = is_cut[:, None] & (self._arange(2)[None, :] < n_cut[:, None])
        out0 = torch.where(is_uncut[:, None], fv, cut_faces[:, 0])
        face_open_valid = torch.stack([is_uncut | cut_valid[:, 0], cut_valid[:, 1] & ~is_uncut], dim=1)
        faces_open = torch.stack([out0, cut_faces[:, 1]], dim=1)
        faces_open = torch.where(face_open_valid[..., None], faces_open, sent).reshape(F * 2, 3)
        face_open_valid = face_open_valid.reshape(F * 2)

        verts_aug = torch.cat([verts_wt, b_verts.reshape(-1, 3)])
        return FlexiMesh(
            verts=verts_aug,
            faces=faces_open,
            face_valid=face_open_valid,
            v_nrm=auto_normals(verts_aug, faces_open, face_open_valid),
            msdf=torch.cat([nu_wt_sg, b_nu.reshape(-1)]),
            msdf_boundary=b_nu.reshape(-1),
            faces_wt=faces_wt,
            face_wt_valid=face_wt_valid,
            n_verts_watertight=center0 + ME,
            l_dev=l_dev,
            n_surf_cubes=n_surf,
            n_crossing_edges=n_cross,
            n_quad_edges=quad_ok_all.sum(),
        )
