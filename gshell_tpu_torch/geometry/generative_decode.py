"""G-Shell ↔ dense cubic grids for the generative pipeline (PyTorch twin of
``gshell_tpu/geometry/generative_decode.py``).

bake: fitted fields on the res-R tet lattice → a feature grid (2R)³×4 —
  sdf sign and deform at vertex sites (even coordinates), the SDF
  interpolation coefficient and the mSDF sign at edge-midpoint sites — an
  occupancy grid (4R)³ of mSDF cut coefficients at the midpoints of the
  template's inscribed edges (canonical endpoint order), and masks of the
  valid sites.  The outermost site plane is cropped, as in the reference.
decode: the marching of :class:`GShellTets` driven by the baked signs and
  coefficients instead of continuous fields.

Grids are channels-last, as the JAX package writes them into ``.npz`` files.
Every site address is a closed-form map of the analytic lattice: vertex
(i, j, k) → 2·(i, j, k), edge midpoint → the sum of its endpoints' lattice
coordinates, inscribed edge → the sum of its two edge midpoints.

Unlike the JAX package, the occupancy scatter writes only valid cut slots,
and where two slots share a site (two tets sharing a template edge) the
higher slot wins, so the result is the same on every device; the JAX
package also scatters its invalid slots, clipped onto some site, with the
value 0 (ROADMAP C)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .gshell_tets import GShellTets

_NEXT = [1, 2, 3, 0]


class BakedGrids(NamedTuple):
    grid: torch.Tensor  # (2R, 2R, 2R, 4): sdf sign / coefficient, deform / mSDF sign
    occgrid: torch.Tensor  # (4R,)³ cut coefficients in [-1, 1]
    feature_mask: torch.Tensor  # (2R, 2R, 2R, 4) valid sites
    occ_mask: torch.Tensor  # (4R,)³ valid sites


class DecodedMesh(NamedTuple):
    """The cut mesh in the extractor's slot layout: rows [0, V) template
    vertices, V a zero vertex, then 4 boundary vertices per tet slot."""
    verts: torch.Tensor
    faces: torch.Tensor  # (4·MT, 3)
    face_valid: torch.Tensor  # (4·MT,)
    n_valid_tets: torch.Tensor
    n_crossing_edges: torch.Tensor


def _key(a, b):
    """Canonical order of a site's two endpoints: > 0 when ``a`` comes first."""
    return (torch.sign(a - b) * torch.tensor([16, 4, 1], device=a.device)).sum(-1)


class GenerativeCodec:
    """Site-address tables and bake / decode for one lattice."""

    def __init__(self, extractor: GShellTets):
        self.ex = extractor
        r, dev = extractor.grid.res, extractor.device
        self.d1, self.d2 = 2 * r + 1, 4 * r + 1
        n = r + 1
        ids = torch.arange(n ** 3, device=dev)
        self.vert_coords = torch.stack([ids // (n * n), (ids // n) % n, ids % n], -1) * 2  # (N, 3)
        e = extractor.edges_pad[:-1]
        self.edge_mid_coords = (self.vert_coords[e[:, 0]] + self.vert_coords[e[:, 1]]) // 2  # (E, 3)

    @torch.no_grad()
    def bake(self, pos, sdf, msdf, deform) -> BakedGrids:
        """Quantize fitted fields on the lattice (``pos`` (N, 3), ``sdf`` /
        ``msdf`` (N,), ``deform`` (N, 3)) into grids."""
        d1, dev = self.d1, sdf.device
        vc, mc = self.vert_coords, self.edge_mid_coords
        feat = torch.zeros((d1, d1, d1, 4), device=dev)
        fmask = torch.zeros((d1, d1, d1, 4), device=dev)
        feat[vc[:, 0], vc[:, 1], vc[:, 2], 0] = torch.sign(sdf)
        feat[vc[:, 0], vc[:, 1], vc[:, 2], 1:4] = deform.float()
        fmask[vc[:, 0], vc[:, 1], vc[:, 2]] = 1.0

        e = self.ex.edges_pad[:-1]
        sa, sb = sdf[e[:, 0]], sdf[e[:, 1]]
        crossing = (sa > 0) != (sb > 0)
        denom = torch.where(torch.abs(sa - sb) > 1e-8, sa - sb, 1.0)
        coeff = torch.clamp(torch.where(crossing, sa / denom, 0.5), 0.0, 1.0)  # vertex = (1-c)·a + c·b
        m_mid = msdf[e[:, 0]] * (1.0 - coeff) + msdf[e[:, 1]] * coeff
        feat[mc[:, 0], mc[:, 1], mc[:, 2], 0] = torch.where(crossing, coeff * 2.0 - 1.0, 0.0)
        feat[mc[:, 0], mc[:, 1], mc[:, 2], 1] = torch.where(crossing, torch.sign(m_mid), 0.0)
        fmask[mc[:, 0], mc[:, 1], mc[:, 2], 0:2] = crossing[:, None].float()

        occ, omask = self._bake_occ(sdf, msdf)
        c1, c2 = self.d1 - 1, self.d2 - 1
        return BakedGrids(feat[:c1, :c1, :c1], occ[:c2, :c2, :c2], fmask[:c1, :c1, :c1], omask[:c2, :c2, :c2])

    def _bake_occ(self, sdf, msdf):
        ex, d2 = self.ex, self.d2
        pairs, w_u, valid, lo_xyz, cls = _cycle_cut_info(ex, sdf, msdf)
        V = ex.max_verts
        valid = valid & (pairs[..., 0] < V) & (pairs[..., 1] < V)
        edge_of_slot = torch.clamp(ex.edge_ids_from(lo_xyz, cls), 0, ex.n_grid_edges - 1)
        mid = self.edge_mid_coords[edge_of_slot]  # (V, 3) midpoint site of each template vertex
        cu, cw = mid[pairs[..., 0][valid]], mid[pairs[..., 1][valid]]
        w_u = w_u[valid]
        val = (torch.where(_key(cu, cw) > 0, w_u, 1.0 - w_u) - 0.5) * 2.0
        site = cu + cw  # ∈ [0, 4R]
        lin = (site[:, 0] * d2 + site[:, 1]) * d2 + site[:, 2]
        slot = torch.arange(lin.shape[0], device=lin.device)
        winner = torch.full((d2 ** 3,), -1, dtype=torch.int64, device=lin.device)
        winner = winner.scatter_reduce(0, lin, slot, "amax")
        keep = winner[lin] == slot
        occ = torch.zeros(d2 ** 3, device=sdf.device)
        omask = torch.zeros(d2 ** 3, device=sdf.device)
        occ[lin[keep]] = val[keep]
        omask[lin[keep]] = 1.0
        return occ.reshape(d2, d2, d2), omask.reshape(d2, d2, d2)

    @torch.no_grad()
    def decode(self, pos, baked: BakedGrids) -> DecodedMesh:
        """Grids → open mesh; ``pos`` (N, 3) are the lattice positions
        (typically the vertices plus max_disp · the baked deform)."""
        grid = torch.nn.functional.pad(baked.grid, (0, 0, 0, 1, 0, 1, 0, 1))  # sign 0 ≡ outside
        occgrid = torch.nn.functional.pad(baked.occgrid, (0, 1, 0, 1, 0, 1))
        vc, mc = self.vert_coords, self.edge_mid_coords
        sdf_sign = grid[vc[:, 0], vc[:, 1], vc[:, 2], 0]
        coeff = grid[mc[:, 0], mc[:, 1], mc[:, 2], 0] * 0.5 + 0.5
        msdf_mid_sign = grid[mc[:, 0], mc[:, 1], mc[:, 2], 1]
        return _marching_from_grids(self.ex, pos, sdf_sign, coeff, msdf_mid_sign, occgrid)


def _cycle_cut_info(ex: GShellTets, sdf, msdf):
    """The extractor's per-tet cycle pairs and mSDF cut weights →
    (pairs (MT, 4, 2) template-vertex slots, w_u (MT, 4), valid (MT, 4),
    lo_xyz (V, 3), cls (V,)) — the last two name each slot's edge."""
    dev = sdf.device
    sdf_p = torch.cat([sdf, torch.ones(1, device=dev)])
    msdf_p = torch.cat([msdf, -torch.ones(1, device=dev)])
    r1 = ex.grid.res + 1
    occ_vol = (sdf > 0).reshape(r1, r1, r1)
    occ_flat = occ_vol.reshape(-1)
    cube_act, cube_xyz, cube_ok = ex.active_cubes(occ_vol)
    tet_valid, corner_xyz, corner_vid, _ = ex.compact_tets(occ_flat, cube_xyz, cube_ok)
    slot_valid, ev0, ev1, lo_xyz, cls, vert_slot_of_edges = ex.compact_edges(occ_flat, cube_act)

    sa, sb = sdf_p[ev0], sdf_p[ev1]
    d = torch.where(torch.abs(sa - sb) > 1e-8, sa - sb, 1.0)
    msdf_vert = torch.where(slot_valid, msdf_p[ev0] * (-sb / d) + msdf_p[ev1] * (sa / d), 0.0)
    msdf_buf = torch.cat([msdf_vert, torch.zeros(1, device=dev)])

    corners = _tet_corners(ex, occ_flat, tet_valid, corner_xyz, corner_vid, vert_slot_of_edges)[0]
    cu, cw = corners, corners[:, _NEXT]
    mu, mw = msdf_buf[cu], msdf_buf[cw]
    sign_ok = torch.abs(torch.sign(mu) + torch.sign(mw)) != 2
    den = mu - mw
    ok = sign_ok & (torch.abs(den) > 1e-8) & tet_valid[:, None]
    w_u = torch.where(ok, -mw / torch.where(ok, den, 1.0), 0.0)
    return torch.stack([cu, cw], -1), w_u, ok, lo_xyz, cls


def _tet_corners(ex: GShellTets, occ_flat, tet_valid, corner_xyz, corner_vid, vert_slot_of_edges):
    """(corners (MT, 4) template slots of each tet's cut cycle, tetindex,
    idx6 (MT, 6) template slots of the tet's edges)."""
    g_occ4 = occ_flat[corner_vid].long()
    tetindex = (g_occ4 * torch.tensor([1, 2, 4, 8], device=g_occ4.device)).sum(-1)
    tetindex = torch.where(tet_valid, tetindex, 15)
    idx6 = vert_slot_of_edges(*ex.tet_edge_lo_cls(corner_xyz), tet_valid[:, None])
    me = torch.clamp(ex.mesh_edge_table[tetindex], 0, 5)
    return torch.gather(idx6, 1, me[:, :4]), tetindex, idx6


def _marching_from_grids(ex: GShellTets, pos, sdf_sign, coeff, msdf_mid_sign, occgrid) -> DecodedMesh:
    V, MT = ex.max_verts, ex.max_tets
    dev = pos.device
    pos_p = torch.cat([pos, torch.zeros((1, 3), device=dev)])
    r1 = ex.grid.res + 1
    occ_vol = (sdf_sign > 0).reshape(r1, r1, r1)
    occ_flat = occ_vol.reshape(-1)
    cube_act, cube_xyz, cube_ok = ex.active_cubes(occ_vol)
    tet_valid, corner_xyz, corner_vid, n_valid = ex.compact_tets(occ_flat, cube_xyz, cube_ok)
    slot_valid, ev0, ev1, lo_xyz, cls, vert_slot_of_edges = ex.compact_edges(occ_flat, cube_act)

    e_clip = torch.clamp(ex.edge_ids_from(lo_xyz, cls), 0, ex.n_grid_edges - 1)
    c = coeff[e_clip][:, None]
    verts = torch.where(slot_valid[:, None], pos_p[ev0] * (1.0 - c) + pos_p[ev1] * c, 0.0)
    msdf_vert = torch.where(slot_valid, msdf_mid_sign[e_clip], 0.0)
    verts_buf = torch.cat([verts, torch.zeros((1, 3), device=dev)])
    msdf_buf = torch.cat([msdf_vert, torch.zeros(1, device=dev)])
    mid = 2 * lo_xyz + ex._edge_offsets[cls]  # midpoint site of each template vertex
    mid_pad = torch.cat([mid, torch.zeros((1, 3), dtype=mid.dtype, device=dev)])

    corners, tetindex, _ = _tet_corners(ex, occ_flat, tet_valid, corner_xyz, corner_vid, vert_slot_of_edges)
    num_tri = ex.num_tri_table[tetindex]
    mocc = (msdf_buf[corners] > 0).long()
    idx_tri = mocc[:, 0] * 4 + mocc[:, 1] * 2 + mocc[:, 2]
    idx_quad = mocc[:, 0] * 8 + mocc[:, 1] * 4 + mocc[:, 2] * 2 + mocc[:, 3]
    is_quad = num_tri == 2

    cu, cw = corners, corners[:, _NEXT]
    m_u, m_w = mid_pad[cu], mid_pad[cw]
    site = torch.clamp(m_u + m_w, 0, occgrid.shape[0] - 1)
    cval = occgrid[site[..., 0], site[..., 1], site[..., 2]] * 0.5 + 0.5
    w_u = torch.where(_key(m_u, m_w) > 0, cval, 1.0 - cval)
    pair_ok = (torch.sign(msdf_buf[cu]) != torch.sign(msdf_buf[cw])) & tet_valid[:, None]
    w_w = torch.where(pair_ok, 1.0 - w_u, 0.0)
    w_u = torch.where(pair_ok, w_u, 0.0)
    b_verts = verts_buf[cu] * w_u[..., None] + verts_buf[cw] * w_w[..., None]

    ar4 = torch.arange(4, device=dev)
    b_gid = (V + 1) + torch.arange(MT, device=dev)[:, None] * 4 + ar4[None, :]
    idx_tri_map = torch.cat([corners[:, :3], b_gid[:, :3]], 1)
    idx_quad_map = torch.cat([corners, b_gid], 1)
    tri_faces = torch.gather(idx_tri_map, 1, torch.clamp(ex.tri_table[idx_tri], 0, 5)).reshape(-1, 2, 3)
    quad_faces = torch.gather(idx_quad_map, 1, torch.clamp(ex.quad_table[idx_quad], 0, 7)).reshape(-1, 4, 3)
    tri_fvalid = (ar4[None] < ex.num_tri_tri[idx_tri][:, None]) & (ar4[None] < 2)
    quad_fvalid = ar4[None] < ex.num_tri_quad[idx_quad][:, None]
    tri_faces4 = torch.cat([tri_faces, torch.full((MT, 2, 3), V, dtype=torch.int64, device=dev)], 1)
    faces = torch.where(is_quad[:, None, None], quad_faces, tri_faces4)
    face_valid = torch.where(is_quad[:, None], quad_fvalid, tri_fvalid) & tet_valid[:, None] & (num_tri > 0)[:, None]
    faces = torch.where(face_valid[..., None], faces, V).reshape(-1, 3)
    return DecodedMesh(torch.cat([verts_buf, b_verts.reshape(-1, 3)]), faces, face_valid.reshape(-1),
                       n_valid, slot_valid.sum())
