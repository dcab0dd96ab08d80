"""G-Shell marching tetrahedra with mSDF open-surface cutting, fixed-capacity
slot buffers (PyTorch twin of ``gshell_tpu/geometry/gshell_tets.py``).

Stage 1 runs marching tets on the SDF signs of a Freudenthal lattice (6 tets
per cube, analytic edge numbering) into a watertight template mesh; stage 2
cuts the template's tri/quad patches by the mSDF sign into open-boundary
triangles.  Valid tets and crossing edges are compacted into fixed-size
slots with validity masks, exactly as the JAX package lays them out, so the
two agree slot for slot.  Gradient semantics follow the reference: the SDF
interpolation weights carry gradients to the SDF and positions, the output
mSDF uses stop-gradient weights, and boundary vertices move with the mSDF
cut coefficients.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.compact import nonzero_compact
from . import tet_tables as tt
from .tet_grid import EDGE_OFFSETS, TetGrid, _PATHS, _edge_class_bases, default_capacities


def _tet_corner_offsets():
    """(6, 4, 3) lattice offsets of each path-tet's corners."""
    out = np.zeros((6, 4, 3), np.int64)
    for p, path in enumerate(_PATHS):
        for s, ax in enumerate(path):
            out[p, s + 1] = out[p, s]
            out[p, s + 1, ax] += 1
    return out


_TET_CORNERS = _tet_corner_offsets()


class GShellMesh(NamedTuple):
    """Extraction result; vertex rows: [0, V) template vertices (one per
    crossing-edge slot), [V] a sentinel zero vertex, [V+1, V+1+4·MT)
    boundary vertices (4 per tet slot)."""

    verts: torch.Tensor  # (V + 1 + 4·MT, 3)
    faces: torch.Tensor  # (4·MT, 3) int64 cut faces
    face_valid: torch.Tensor  # (4·MT,) bool
    msdf: torch.Tensor  # (V + 1 + 4·MT,) stop-vgrad mSDF at every vertex
    msdf_boundary: torch.Tensor  # (4·MT,)
    n_verts_watertight: int  # V + 1
    n_valid_tets: torch.Tensor
    n_crossing_edges: torch.Tensor
    edge_sdf: torch.Tensor  # (V, 2) gradient-carrying SDF at crossing-edge endpoints


def _safe_inv_denominator(d, valid):
    """1/d with a 1e-8 magnitude floor (finite f32 gradients)."""
    d = torch.where(valid, d, 1.0)
    mag = torch.clamp(torch.abs(d), min=1e-8)
    return torch.where(d >= 0, 1.0, -1.0) / mag


class GShellTets:
    """Statically-shaped G-Shell marching tets over a :class:`TetGrid`."""

    def __init__(self, grid: TetGrid, device, max_tets: int | None = None,
                 max_verts: int | None = None):
        if max_tets is None or max_verts is None:
            d_tets, d_verts = default_capacities(grid.res, grid.n_tets, grid.n_edges)
            max_tets = max_tets or d_tets
            max_verts = max_verts or d_verts
        self.grid = grid
        self.device = torch.device(device)
        self.max_tets = int(max_tets)
        self.max_verts = int(max_verts)
        self.n_grid_verts = grid.n_verts
        self.n_grid_edges = grid.n_edges
        self.max_cubes = max(self.max_tets // 4, 1)
        self.max_lat_verts = min(3 * self.max_cubes, grid.n_verts)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=self.device)
        self._edge_offsets = as_t(EDGE_OFFSETS)
        self._edge_bases = as_t(_edge_class_bases(grid.res))
        self._tet_corners = as_t(_TET_CORNERS)
        key_to_cls = np.full(8, -1, np.int64)
        for i, o in enumerate(EDGE_OFFSETS):
            key_to_cls[o[0] * 4 + o[1] * 2 + o[2]] = i
        self._key_to_cls = as_t(key_to_cls)
        self.mesh_edge_table = as_t(tt.MESH_EDGE_TABLE)
        self.tri_table = as_t(tt.TRIANGLE_TABLE_TRI)
        self.quad_table = as_t(tt.TRIANGLE_TABLE_QUAD)
        self.num_tri_table = as_t(tt.NUM_TRIANGLES_TABLE)
        self.num_tri_tri = as_t(tt.NUM_TRIANGLES_TRI_TABLE)
        self.num_tri_quad = as_t(tt.NUM_TRIANGLES_QUAD_TABLE)

    def _arange(self, n):
        return torch.arange(n, dtype=torch.int64, device=self.device)

    @property
    def edges_pad(self) -> torch.Tensor:
        """(E + 1, 2) lattice edges, low vertex first, in the global edge
        numbering (class-major, then the lower corner raveled), and a
        sentinel row (N, N); built closed-form on first use."""
        if not hasattr(self, "_edges_pad"):
            n = self.grid.res + 1
            vid = self._arange(n ** 3).reshape(n, n, n)
            rows = [torch.stack([vid[:n - ox, :n - oy, :n - oz].reshape(-1), vid[ox:, oy:, oz:].reshape(-1)], -1)
                    for ox, oy, oz in EDGE_OFFSETS.tolist()]
            rows.append(torch.full((1, 2), self.n_grid_verts, dtype=torch.int64, device=self.device))
            self._edges_pad = torch.cat(rows)
        return self._edges_pad

    def edge_ids_from(self, lo_xyz, cls):
        """(lower-corner lattice coords, class) → global edge id."""
        n = self.grid.res + 1
        o = self._edge_offsets[cls]
        local = (lo_xyz[..., 0] * (n - o[..., 1]) + lo_xyz[..., 1]) * (n - o[..., 2]) + lo_xyz[..., 2]
        return self._edge_bases[cls] + local

    def active_cubes(self, occ_vol):
        """Cube activity (8 corners mix signs) + compacted cube coords."""
        res = self.grid.res
        vol_i = occ_vol.to(torch.int32)
        csum = sum(
            vol_i[dx:dx + res, dy:dy + res, dz:dz + res]
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
        )
        cube_act = (csum > 0) & (csum < 8)
        n_cubes = res**3
        cube_slots = nonzero_compact(cube_act, self.max_cubes, n_cubes)
        cube_ok = cube_slots < n_cubes
        cs = torch.where(cube_ok, cube_slots, 0)
        cube_xyz = torch.stack([cs // (res * res), (cs // res) % res, cs % res], dim=-1)
        return cube_act, cube_xyz, cube_ok

    def compact_tets(self, occ_flat, cube_xyz, cube_ok):
        """Candidate tets of active cubes → MT slots (ascending global tet
        id) → (tet_valid, corner_xyz (MT, 4, 3), corner_vid (MT, 4), n_valid)."""
        n_lat = self.grid.res + 1
        MC, MT = self.max_cubes, self.max_tets
        corner8 = self._arange(8)
        off8_vid = ((corner8 >> 2) * n_lat + ((corner8 >> 1) & 1)) * n_lat + (corner8 & 1)
        base_vid = (cube_xyz[:, 0] * n_lat + cube_xyz[:, 1]) * n_lat + cube_xyz[:, 2]
        occ8 = occ_flat[base_vid[:, None] + off8_vid[None, :]]  # (MC, 8)
        tc = _TET_CORNERS
        m64 = torch.as_tensor((tc[..., 0] * 4 + tc[..., 1] * 2 + tc[..., 2]).reshape(-1),
                              device=self.device)
        cand_sum = occ8[:, m64].reshape(MC, 6, 4).sum(dim=-1)
        valid_cand = (cand_sum > 0) & (cand_sum < 4) & cube_ok[:, None]
        n_valid = valid_cand.sum()
        cand_idx = nonzero_compact(valid_cand, MT, 6 * MC)
        tet_valid = cand_idx < 6 * MC
        ci = torch.where(tet_valid, cand_idx, 0)
        corner_xyz = cube_xyz[ci // 6][:, None, :] + self._tet_corners[ci % 6]
        corner_vid = (corner_xyz[..., 0] * n_lat + corner_xyz[..., 1]) * n_lat + corner_xyz[..., 2]
        return tet_valid, corner_xyz, corner_vid, n_valid

    def compact_edges(self, occ_flat, cube_act):
        """Crossing edges of the dilated active-cube vertex set → V template
        vertex slots → (slot_valid, ev0, ev1, lo_xyz, cls,
        vert_slot_of_edges): endpoint vertex ids and each slot's edge as
        lower corner and class."""
        n_lat = self.grid.res + 1
        N, V, MVL = self.n_grid_verts, self.max_verts, self.max_lat_verts
        act_pad = torch.nn.functional.pad(cube_act, (1, 1, 1, 1, 1, 1))
        vert_act = torch.zeros((n_lat,) * 3, dtype=torch.bool, device=self.device)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    vert_act = vert_act | act_pad[dx:dx + n_lat, dy:dy + n_lat, dz:dz + n_lat]
        lv_slots = nonzero_compact(vert_act, MVL, N)
        lv_ok = lv_slots < N
        lv = torch.where(lv_ok, lv_slots, 0)
        lv_xyz = torch.stack([lv // (n_lat * n_lat), (lv // n_lat) % n_lat, lv % n_lat], dim=-1)
        # lattice vertex → compacted slot (MVL = none); index N+1 is a dump row
        slot_of_lv = torch.full((N + 2,), MVL, dtype=torch.int64, device=self.device)
        slot_of_lv[torch.where(lv_ok, lv_slots, N + 1)] = self._arange(MVL)
        slot_of_lv = slot_of_lv[:N + 1]

        occ_vol = occ_flat.reshape(n_lat, n_lat, n_lat)
        cross_bits = torch.zeros((n_lat,) * 3, dtype=torch.int64, device=self.device)
        for c, (ox, oy, oz) in enumerate(EDGE_OFFSETS.tolist()):
            x = occ_vol[:n_lat - ox, :n_lat - oy, :n_lat - oz] ^ occ_vol[ox:, oy:, oz:]
            cross_bits = cross_bits + (
                torch.nn.functional.pad(x.to(torch.int64), (0, oz, 0, oy, 0, ox)) << c
            )
        cb = cross_bits.reshape(-1)[lv]
        e_cross = ((cb[:, None] >> self._arange(7)[None, :]) & 1).bool() & lv_ok[:, None]
        ce_idx = nonzero_compact(e_cross, V, 7 * MVL)
        slot_valid = ce_idx < 7 * MVL
        cei = torch.where(slot_valid, ce_idx, 0)
        li, cls = cei // 7, cei % 7
        lo_xyz = lv_xyz[li]
        hi_xyz = lo_xyz + self._edge_offsets[cls]
        ev0 = torch.where(slot_valid, lv[li], N)
        ev1 = torch.where(slot_valid, (hi_xyz[..., 0] * n_lat + hi_xyz[..., 1]) * n_lat + hi_xyz[..., 2], N)

        vert_of_cand = torch.full((7 * MVL + 2,), V, dtype=torch.int64, device=self.device)
        vert_of_cand[torch.where(slot_valid, ce_idx, 7 * MVL + 1)] = self._arange(V)
        vert_of_cand = vert_of_cand[:7 * MVL + 1]

        def vert_slot_of_edges(e_lo_xyz, e_cls, valid):
            vid = (e_lo_xyz[..., 0] * n_lat + e_lo_xyz[..., 1]) * n_lat + e_lo_xyz[..., 2]
            lvs = slot_of_lv[torch.where(valid, vid, N)]
            return vert_of_cand[torch.where(lvs < MVL, lvs * 7 + e_cls, 7 * MVL)]

        return slot_valid, ev0, ev1, lo_xyz, cls, vert_slot_of_edges

    def tet_edge_lo_cls(self, corner_xyz):
        """Per tet edge [01,02,03,12,13,23]: (lower corner, edge class)."""
        pa = corner_xyz[..., [0, 0, 0, 1, 1, 2], :]
        pb = corner_xyz[..., [1, 2, 3, 2, 3, 3], :]
        off = torch.abs(pb - pa)
        return torch.minimum(pa, pb), self._key_to_cls[off[..., 0] * 4 + off[..., 1] * 2 + off[..., 2]]

    def __call__(self, pos, sdf, msdf, sdf_fn=None, msdf_fn=None) -> GShellMesh:
        """Extract the open-surface mesh.  ``pos`` (N, 3) deformed lattice,
        ``sdf``/``msdf`` (N,).  With ``sdf_fn`` / ``msdf_fn`` (lazy
        gradients, ``(rows, 3) → (rows,)``) the dense field is read only for
        signs and the gradient-carrying values are re-evaluated at the
        crossing-edge endpoints."""
        V, MT = self.max_verts, self.max_tets
        dev = self.device
        res = self.grid.res
        n_lat = res + 1
        nv, nt = V, MT
        pos_p = torch.cat([pos, torch.zeros((1, 3), dtype=pos.dtype, device=dev)], dim=0)
        sdf_p = torch.cat([sdf, torch.ones((1,), dtype=sdf.dtype, device=dev)], dim=0)
        msdf_p = torch.cat([msdf, -torch.ones((1,), dtype=msdf.dtype, device=dev)], dim=0)

        occ_vol = (sdf > 0).reshape(n_lat, n_lat, n_lat)
        occ_flat = occ_vol.reshape(-1)
        cube_act, cube_xyz, cube_ok = self.active_cubes(occ_vol)
        tet_valid, corner_xyz, corner_vid, n_valid = self.compact_tets(occ_flat, cube_xyz, cube_ok)

        n_cross = sum(
            (occ_vol[:n_lat - ox, :n_lat - oy, :n_lat - oz] != occ_vol[ox:, oy:, oz:]).sum()
            for ox, oy, oz in EDGE_OFFSETS.tolist()
        )
        slot_valid, ev0, ev1, _, _, vert_slot_of_edges = self.compact_edges(occ_flat, cube_act)

        # ---- crossing edges → template vertices --------------------------------
        pa, pb = pos_p[ev0], pos_p[ev1]
        if sdf_fn is not None:
            sab = sdf_fn(torch.cat([pa, pb], dim=0))
            sa = torch.where(slot_valid, sab[:nv], 1.0)
            sb = torch.where(slot_valid, sab[nv:], 1.0)
        else:
            sa, sb = sdf_p[ev0], sdf_p[ev1]
        denom_inv = _safe_inv_denominator(sa - sb, slot_valid)
        wa = -sb * denom_inv
        wb = sa * denom_inv
        verts = torch.where(slot_valid[:, None], pa * wa[:, None] + pb * wb[:, None], 0.0)
        if msdf_fn is not None:
            mab = msdf_fn(torch.cat([pa, pb], dim=0))
            ma = torch.where(slot_valid, mab[:nv], -1.0)
            mb = torch.where(slot_valid, mab[nv:], -1.0)
        else:
            ma, mb = msdf_p[ev0], msdf_p[ev1]
        msdf_vert = torch.where(slot_valid, ma * wa + mb * wb, 0.0)
        msdf_vert_sg = torch.where(slot_valid, ma * wa.detach() + mb * wb.detach(), 0.0)

        zero1 = torch.zeros((1,), dtype=pos.dtype, device=dev)
        verts_buf = torch.cat([verts, torch.zeros((1, 3), dtype=pos.dtype, device=dev)], dim=0)
        msdf_buf = torch.cat([msdf_vert, zero1])
        msdf_sg_buf = torch.cat([msdf_vert_sg, zero1])

        # ---- per-tet template faces -----------------------------------------
        g_occ4 = occ_flat[corner_vid].to(torch.int64)
        tetindex = (g_occ4 * torch.tensor([1, 2, 4, 8], device=dev)).sum(dim=-1)
        tetindex = torch.where(tet_valid, tetindex, 15)
        num_tri = self.num_tri_table[tetindex]
        te_lo, te_cls = self.tet_edge_lo_cls(corner_xyz)
        idx6 = vert_slot_of_edges(te_lo, te_cls, tet_valid[:, None])  # (nt, 6)

        # ---- mSDF cutting -----------------------------------------------------
        me = torch.clamp(self.mesh_edge_table[tetindex], 0, 5)
        corners = torch.gather(idx6, 1, me[:, :4])  # (nt, 4) ∈ [0, V]
        cattr = torch.cat([verts_buf, msdf_buf[:, None], msdf_sg_buf[:, None]], dim=1)[corners]
        c_msdf, c_msdf_sg = cattr[..., 3], cattr[..., 4]
        mocc = (c_msdf > 0).to(torch.int64)
        is_quad = num_tri == 2
        idx_tri = mocc[:, 0] * 4 + mocc[:, 1] * 2 + mocc[:, 2]
        idx_quad = mocc[:, 0] * 8 + mocc[:, 1] * 4 + mocc[:, 2] * 2 + mocc[:, 3]

        nxt = [1, 2, 3, 0]
        mu, mw = c_msdf, c_msdf[:, nxt]
        mu_sg, mw_sg = c_msdf_sg, c_msdf_sg[:, nxt]
        sign_ok = torch.abs(torch.sign(mu) + torch.sign(mw)) != 2
        denom = mu - mw
        cut_ok = sign_ok & (torch.abs(denom) > 1e-8) & tet_valid[:, None]
        denom_safe = torch.where(cut_ok, denom, 1.0)
        bu = torch.where(cut_ok, -mw / denom_safe, 0.0)
        bw = torch.where(cut_ok, mu / denom_safe, 0.0)
        vu = cattr[..., 0:3]
        b_verts = vu * bu[..., None] + vu[:, nxt] * bw[..., None]
        b_msdf = mu_sg * bu.detach() + mw_sg * bw.detach()

        b_gid = (V + 1) + self._arange(nt)[:, None] * 4 + self._arange(4)[None, :]
        idx_tri_map = torch.cat([corners[:, :3], b_gid[:, :3]], dim=1)
        idx_quad_map = torch.cat([corners, b_gid], dim=1)
        tri_row = torch.clamp(self.tri_table[idx_tri], 0, 5)
        quad_row = torch.clamp(self.quad_table[idx_quad], 0, 7)
        tri_faces = torch.gather(idx_tri_map, 1, tri_row).reshape(-1, 2, 3)
        quad_faces = torch.gather(idx_quad_map, 1, quad_row).reshape(-1, 4, 3)
        farange = self._arange(4)[None, :]
        tri_fvalid = (farange < self.num_tri_tri[idx_tri][:, None]) & (farange < 2)
        quad_fvalid = farange < self.num_tri_quad[idx_quad][:, None]
        tri_faces4 = torch.cat(
            [tri_faces, torch.full((nt, 2, 3), V + 1 + 4 * MT, dtype=torch.int64, device=dev)], dim=1
        )
        faces_aug = torch.where(is_quad[:, None, None], quad_faces, tri_faces4)
        face_valid = torch.where(is_quad[:, None], quad_fvalid, tri_fvalid)
        face_valid = face_valid & tet_valid[:, None] & (num_tri > 0)[:, None]
        faces_aug = torch.where(face_valid[..., None], faces_aug, V).reshape(-1, 3)
        face_valid = face_valid.reshape(-1)

        b_mask = tet_valid[:, None] & cut_ok
        b_verts = torch.where(b_mask[..., None], b_verts, 0.0).reshape(-1, 3)
        b_msdf = torch.where(b_mask, b_msdf, 0.0).reshape(-1)
        return GShellMesh(
            verts=torch.cat([verts_buf, b_verts], dim=0),
            faces=faces_aug,
            face_valid=face_valid,
            msdf=torch.cat([msdf_sg_buf, b_msdf], dim=0),
            msdf_boundary=b_msdf,
            n_verts_watertight=V + 1,
            n_valid_tets=n_valid,
            n_crossing_edges=n_cross,
            edge_sdf=torch.stack([sa, sb], dim=-1),
        )

