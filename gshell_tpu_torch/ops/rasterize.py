"""Differentiable binned rasterizer: coverage, interpolation, antialias.

PyTorch counterpart of ``gshell_tpu/ops/rasterize.py``.

  * ``rasterize`` / ``rasterize_peel`` — the exact scan over face chunks, the
    oracle: per pixel the ``n_layers`` least (depth, id) pairs.  Plain
    PyTorch; the renderer takes it where the resolution is not a multiple of
    the tile.
  * ``rasterize_tiled`` — stage A bins (triangle, tile) pairs with sorts and
    cumulative sums; stage B (:func:`rasterize_stage_b`) finds each pixel's
    nearest covering triangle.  On a CUDA tensor stage B is the hand-written
    kernel ``csrc/rasterize_stage_b.cu``; on a CPU tensor it is the plain
    PyTorch version beside it.
  * ``rasterize_tiled_peel`` — that first layer and, over the same tile
    segments, the second (:func:`stage_b_second`, plain PyTorch), the
    surface the renderer's second layer shades.  Outputs are discrete and
    carry no gradient.
  * ``interpolate`` / ``bary_screen_derivs`` re-derive barycentrics from
    ``v_clip`` so gradients reach vertex positions; ``antialias`` moves
    silhouettes.  Both follow the JAX functions line for line.

Triangle ids in :class:`Rast` are 1-based; 0 is background.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import kernels
from .gather import gather_rows

_W_EPS = 1e-6
_BIG = 3.4e38
TILE = 16  # screen tile side in pixels (kTile of csrc/rasterize_stage_b.cu)
_PX = TILE * TILE
_CHUNK = 16384  # pairs per block of the plain stage B
STAGE_B_SUB = 32  # most pairs per sub-segment of the stage-B kernel (kSub)

_layout_checked = False


class Rast(NamedTuple):
    tri_id: torch.Tensor  # (H, W) int64; 0 = background, else face index + 1
    bary: torch.Tensor  # (H, W, 2) perspective-correct (b0, b1)
    zbuf: torch.Tensor  # (H, W) NDC depth of the hit (+BIG at background)
    dropped: torch.Tensor | int = 0  # (triangle, tile) pairs beyond stage A's buffer


def _pixel_centers(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    return ys, xs


def _pixel_grid(h: int, w: int, device):
    ys, xs = _pixel_centers(h, w, device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _tri_screen(v_clip, faces, h: int, w: int):
    """Screen-space positions (x in [0,W], y in [0,H]) + ndc z + 1/w per corner."""
    tri = v_clip[faces]  # (F, 3, 4)
    ww = tri[..., 3]
    valid_w = ww > _W_EPS
    inv_w = torch.where(valid_w, 1.0 / torch.clamp(ww, min=_W_EPS), 0.0)
    ndc = tri[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * w
    sy = (ndc[..., 1] * 0.5 + 0.5) * h
    return sx, sy, ndc[..., 2], inv_w, valid_w.all(dim=-1)


def _edge_coeffs(sx, sy):
    """Edge k is opposite corner k: e_k(p) = a_k x + b_k y + c_k."""
    x0, x1, x2 = sx[..., 0], sx[..., 1], sx[..., 2]
    y0, y1, y2 = sy[..., 0], sy[..., 1], sy[..., 2]
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - x2 * y1
    a1, b1, c1 = y2 - y0, x0 - x2, x2 * y0 - x0 * y2
    a2, b2, c2 = y0 - y1, x1 - x0, x0 * y1 - x1 * y0
    area2 = a2 * (x2 - x0) + b2 * (y2 - y0)
    a = torch.stack([a0, a1, a2], -1)
    b = torch.stack([b0, b1, b2], -1)
    c = torch.stack([c0, c1, c2], -1)
    return a, b, c, area2


# ----------------------------------------------------------------------------
# The scan: exact, every face against every pixel
# ----------------------------------------------------------------------------


def rasterize(v_clip, faces, resolution, chunk: int = 128) -> Rast:
    """The nearest covering triangle per pixel by the scan (JAX
    ``rasterize`` :90); ``faces`` (F, 3), degenerate faces never cover."""
    return rasterize_peel(v_clip, faces, resolution, chunk=chunk, n_layers=1)[0]


@torch.no_grad()
def rasterize_peel(v_clip, faces, resolution, chunk: int = 128, n_layers: int = 1) -> list:
    """Depth-peeled rasterization (JAX ``rasterize_peel`` :104): the k-th
    :class:`Rast` holds each pixel's k-th nearest surface.  Faces go in
    chunks of ``chunk``; each pixel keeps its ``n_layers`` least (z, id)
    pairs sorted, a candidate entering only where it is strictly less, and
    within a chunk the first index wins among equal z — so the layers are
    the lexicographically least (z, id) pairs.  Coverage: orientation-
    normalised edge functions under the top-left rule; z = Σ (e_k/area)·z_k
    in [-1, 1]."""
    h, w = resolution
    dev = v_clip.device
    f = faces.shape[0]
    pad = (-f) % chunk
    # padded rows gather v_clip[0] three times → zero area → culled
    faces_p = F.pad(faces, (0, 0, 0, pad))
    sx, sy, z, _, tri_ok = _tri_screen(v_clip, faces_p, h, w)
    tri_ok = tri_ok & (torch.arange(faces_p.shape[0], device=dev) < f)
    a, b, c, area2 = _edge_coeffs(sx, sy)
    px, py = _pixel_grid(h, w, dev)
    px, py = px[:, None], py[:, None]
    nonzero = area2.abs() > 1e-12
    area_safe = torch.where(nonzero, area2, 1.0)
    zs = [torch.full((h * w,), _BIG, dtype=torch.float32, device=dev) for _ in range(n_layers)]
    ids = [torch.full((h * w,), -1, dtype=torch.int64, device=dev) for _ in range(n_layers)]
    rows = torch.arange(h * w, device=dev)
    for lo in range(0, faces_p.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        s_or = torch.sign(area2[sl])
        cover = (nonzero[sl] & tri_ok[sl])[None, :]
        depth = None
        for k in range(3):
            ck_a, ck_b = a[sl, k], b[sl, k]
            e = ck_a * px + ck_b * py + c[sl, k]  # (P, chunk)
            eo = e * s_or
            ao, bo = ck_a * s_or, ck_b * s_or
            on_edge_ok = (ao > 0.0) | ((ao == 0.0) & (bo > 0.0))
            cover = cover & ((eo > 0.0) | ((eo == 0.0) & on_edge_ok))
            term = (e / area_safe[sl]) * z[sl, k]
            depth = term if depth is None else depth + term
        cover = cover & (depth >= -1.0) & (depth <= 1.0)
        depth = torch.where(cover, depth, _BIG)
        for _ in range(n_layers):  # the chunk's n best, merged into the sorted lists
            k = torch.argmin(depth, dim=-1)
            cand_z = depth[rows, k]
            cand_id = lo + k
            depth[rows, k] = _BIG
            for l in range(n_layers):
                better = cand_z < zs[l]
                zs[l], cand_z = torch.where(better, cand_z, zs[l]), torch.where(better, zs[l], cand_z)
                ids[l], cand_id = torch.where(better, cand_id, ids[l]), torch.where(better, ids[l], cand_id)
    out = []
    for l in range(n_layers):
        hit = ids[l] >= 0
        tri_id = torch.where(hit, ids[l] + 1, 0)
        bary = _recompute_bary(v_clip, faces, tri_id, px[:, 0], py[:, 0], h, w)
        out.append(Rast(tri_id=tri_id.reshape(h, w), bary=bary.reshape(h, w, 2),
                        zbuf=torch.where(hit, zs[l], _BIG).reshape(h, w)))
    return out


@torch.no_grad()
def scan_depth(v_clip, faces, tri_id):
    """The scan's depth Σ (e_k/area)·z_k of face ``tri_id - 1`` at each
    pixel of an (H, W) id image (BIG where the id is 0)."""
    h, w = tri_id.shape
    ids = tri_id.reshape(-1) - 1
    sx, sy, z, _, _ = _tri_screen(v_clip, faces[ids.clamp(min=0)], h, w)
    a, b, c, area2 = _edge_coeffs(sx, sy)
    px, py = _pixel_grid(h, w, v_clip.device)
    safe = torch.where(area2.abs() > 1e-12, area2, 1.0)
    depth = None
    for k in range(3):
        term = ((a[:, k] * px + b[:, k] * py + c[:, k]) / safe) * z[:, k]
        depth = term if depth is None else depth + term
    return torch.where(ids >= 0, depth, _BIG).reshape(h, w)


@torch.no_grad()
def layer_differences(rast, oracle, v_clip, faces, tol: float = 1e-6) -> dict:
    """Where ``rast`` picks another triangle than the scan ``oracle`` (same
    layer): ``differ`` pixels, of which ``ties`` — both candidates' scan
    depths within ``tol``, or one side a miss and the other's depth within
    ``tol`` of the [-1, 1] bounds — which a different depth rounding may
    order either way; ``unexplained`` is the rest."""
    diff = rast.tri_id != oracle.tri_id
    za, zb = scan_depth(v_clip, faces, rast.tri_id), scan_depth(v_clip, faces, oracle.tri_id)
    both = (rast.tri_id > 0) & (oracle.tri_id > 0)
    hit_z = torch.where(rast.tri_id > 0, za, zb)
    tie = torch.where(both, (za - zb).abs() <= tol, (hit_z.abs() - 1.0).abs() <= tol)
    n_diff, n_tie = int(diff.sum()), int((diff & tie).sum())
    return {"differ": n_diff, "ties": n_tie, "unexplained": n_diff - n_tie}


# ----------------------------------------------------------------------------
# Stage B: the kernel and its plain version
# ----------------------------------------------------------------------------


def _segment_best(pair_data, seg_start, seg_cnt, seg_tile, tx_n: int, exclude=None):
    """Each segment's per-pixel winner over the TILE² pixels of its tile.

    Each pair is evaluated against its tile's pixels as a (_CHUNK, TILE²)
    depth block (BIG where not covered); per (segment, pixel) the least depth
    wins (``scatter_reduce amin``), then the least id among the pairs at that
    depth.  ``exclude`` (n_seg, TILE²) int32: a triangle id each pixel skips
    (the first layer's winner, for the second).  Returns (best_z (n_seg,
    TILE²) f32, best_id (n_seg, TILE²) int32, -1 = miss)."""
    dev = pair_data.device
    n_seg = seg_cnt.shape[0]
    cnt = seg_cnt.long()
    total = int(cnt.sum())
    best_z = torch.full((n_seg * _PX,), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((n_seg * _PX,), -1, dtype=torch.int32, device=dev)
    if total == 0:
        return best_z.view(n_seg, _PX), best_id.view(n_seg, _PX)
    segs = torch.repeat_interleave(torch.arange(n_seg, device=dev), cnt)
    seg0 = torch.cumsum(cnt, 0) - cnt
    rows = torch.repeat_interleave(seg_start.long(), cnt) + (
        torch.arange(total, device=dev) - torch.repeat_interleave(seg0, cnt)
    )
    tiles = seg_tile.long()[segs]
    lin = torch.arange(_PX, device=dev)

    def chunk_depth(lo):
        t = tiles[lo:lo + _CHUNK]
        s = pair_data[rows[lo:lo + _CHUNK]]  # (k, 16)
        py = ((t // tx_n)[:, None] * TILE + lin[None] // TILE).float() + 0.5
        px = ((t % tx_n)[:, None] * TILE + lin[None] % TILE).float() + 0.5
        ar = s[:, 12:13]
        s_or = torch.sign(ar)
        cover = ar.abs() > 1e-12
        depth_num = None
        for e in range(3):
            a, b, c, z = s[:, e:e + 1], s[:, 3 + e:4 + e], s[:, 6 + e:7 + e], s[:, 9 + e:10 + e]
            ev = a * px + b * py + c
            eo = ev * s_or
            ao = a * s_or
            bo = b * s_or
            edge_ok = (ao > 0.0) | ((ao == 0.0) & (bo > 0.0))
            cover = cover & ((eo > 0.0) | ((eo == 0.0) & edge_ok))
            depth_num = ev * z if depth_num is None else depth_num + ev * z
        depth = depth_num * (1.0 / torch.where(ar.abs() > 1e-12, ar, 1.0))
        cover = cover & (depth >= -1.0) & (depth <= 1.0)
        depth = torch.where(cover, depth, _BIG)
        flat = (segs[lo:lo + _CHUNK][:, None] * _PX + lin[None]).reshape(-1)
        ids = (s[:, 13:14].to(torch.int32) - 1).expand_as(depth).reshape(-1)
        depth = depth.reshape(-1)
        if exclude is not None:
            depth = torch.where(ids == exclude.reshape(-1)[flat], _BIG, depth)
        return depth, flat, ids

    for lo in range(0, total, _CHUNK):  # pass 1: least depth
        depth, flat, _ = chunk_depth(lo)
        best_z.scatter_reduce_(0, flat, depth, reduce="amin")
    big_id = torch.iinfo(torch.int32).max
    best_id.fill_(big_id)
    for lo in range(0, total, _CHUNK):  # pass 2: least id at that depth
        depth, flat, ids = chunk_depth(lo)
        win = (depth == best_z[flat]) & (depth < _BIG)
        best_id.scatter_reduce_(0, flat, torch.where(win, ids, big_id), reduce="amin")
    best_id = torch.where(best_id == big_id, -1, best_id)
    return best_z.view(n_seg, _PX), best_id.view(n_seg, _PX)


def stage_b_plain(pair_data, tile_start, tile_cnt, n_tiles: int, tx_n: int):
    """Plain PyTorch stage B, the reference for ``csrc/rasterize_stage_b.cu``:
    each tile's whole segment (no per-tile cap), least depth then least id.
    Returns (best_z (n_tiles, TILE²) f32, best_id (n_tiles, TILE²) int32,
    -1 = miss)."""
    tiles = torch.arange(n_tiles, device=pair_data.device)
    return _segment_best(pair_data, tile_start, tile_cnt, tiles, tx_n)


def stage_b_second(pair_data, tile_start, tile_cnt, n_tiles: int, tx_n: int, first_id):
    """The second layer over each tile's whole segment, in plain PyTorch:
    the least depth, then the least id at it, over the pairs whose id is not
    the first layer's winner ``first_id`` ((n_tiles, TILE²) int32, stage B's
    ``best_id``) — the lexicographically second (z, id), as the scan's
    layer 2.  Depth is stage B's (``depth_num · (1/area)``).  Returns
    (best_z, best_id) as (n_tiles, TILE²) f32 / int32, -1 = miss."""
    tiles = torch.arange(n_tiles, device=pair_data.device)
    return _segment_best(pair_data, tile_start, tile_cnt, tiles, tx_n, exclude=first_id)


def stage_b_max_subs(n_tiles: int, max_pairs: int, sub: int = STAGE_B_SUB) -> int:
    """Rows of the kernel's sub-segment table, known without a host sync:
    sum(ceil(cnt / sub)) <= n_tiles + sum(cnt) // sub <= n_tiles +
    max_pairs // sub."""
    return n_tiles + max_pairs // sub


def stage_b_schedule(tile_start, tile_cnt, sub: int = STAGE_B_SUB):
    """The kernel's sub-segment table (``stage_b_schedule`` in the CUDA
    source): one row (tile, first pair, pairs, sub-segments of that tile)
    for each sub-segment of at most ``sub`` pairs, tiles in order.
    (n_subs, 4) int64."""
    dev = tile_cnt.device
    cnt = tile_cnt.long()
    nsub = (cnt + sub - 1) // sub
    tiles = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), nsub)
    k = torch.arange(tiles.shape[0], device=dev) - (torch.cumsum(nsub, 0) - nsub)[tiles]
    return torch.stack([tiles, tile_start.long()[tiles] + k * sub,
                        torch.clamp(cnt[tiles] - k * sub, max=sub), nsub[tiles]], dim=1)


_MISS_KEY = torch.iinfo(torch.int64).max


def pack_key(z, ids):
    """(order-preserving bits of z) · 2³² + id as int64, so that the least
    key is the least z, then the least id; -0.0 counts as +0.0."""
    bits = (z + 0.0).view(torch.int32)  # -0 + 0 = +0
    s = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return s.long() * (1 << 32) + ids.long()


def unpack_key(key):
    """Inverse of :func:`pack_key`; the miss key gives (BIG, -1)."""
    s = (key >> 32).to(torch.int32)
    z = (s ^ ((s >> 31) & 0x7FFFFFFF)).view(torch.float32)
    ids = (key & 0xFFFFFFFF).to(torch.int32)
    miss = key == _MISS_KEY
    return torch.where(miss, _BIG, z), torch.where(miss, -1, ids)


def stage_b_split_merge(pair_data, tile_start, tile_cnt, n_tiles: int, tx_n: int):
    """The CUDA kernel's schedule in plain PyTorch: each tile's segment cut
    into sub-segments of at most STAGE_B_SUB pairs, each sub-segment's winner
    per pixel, then the tiles with one sub-segment take it directly and the
    others merge their sub-segments' keys (:func:`pack_key`) with ``amin``,
    as the kernel's 64-bit ``atomicMin`` does.  Same outputs as
    :func:`stage_b_plain`."""
    dev = pair_data.device
    subs = stage_b_schedule(tile_start, tile_cnt)
    z, ids = _segment_best(pair_data, subs[:, 1], subs[:, 2], subs[:, 0], tx_n)
    best_z = torch.full((n_tiles, _PX), _BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((n_tiles, _PX), -1, dtype=torch.int32, device=dev)
    one = subs[:, 3] == 1
    best_z[subs[one, 0]] = z[one]
    best_id[subs[one, 0]] = ids[one]
    many = ~one
    keys = torch.where(ids[many] >= 0, pack_key(z[many], ids[many]), _MISS_KEY)
    merged = torch.full((n_tiles, _PX), _MISS_KEY, dtype=torch.int64, device=dev)
    merged.scatter_reduce_(0, subs[many, 0:1].expand(-1, _PX), keys, reduce="amin")
    tiles = torch.unique(subs[many, 0])
    best_z[tiles], best_id[tiles] = unpack_key(merged[tiles])
    return best_z, best_id


def _stage_b_lib():
    """The kernel library, once checked to cut tiles and sub-segments as
    TILE and STAGE_B_SUB say (they size the table and model the kernel)."""
    global _layout_checked
    lib = kernels.lib()
    if not _layout_checked:
        tile, sub = ctypes.c_int(), ctypes.c_int()
        lib.gs_stage_b_layout(ctypes.byref(tile), ctypes.byref(sub))
        if (tile.value, sub.value) != (TILE, STAGE_B_SUB):
            raise RuntimeError(f"stage-B kernel built for tile {tile.value}, sub-segments of {sub.value}; "
                               f"rasterize.py expects {TILE}, {STAGE_B_SUB}")
        _layout_checked = True
    return lib


def rasterize_stage_b(pair_data, tile_start, tile_cnt, n_tiles: int, tx_n: int):
    """Stage B on CUDA tensors: the hand kernel; on CPU tensors: the plain
    version.  ``pair_data`` (P, 16) f32 row-major, sorted by tile, 16-byte
    aligned; ``tile_start``/``tile_cnt`` (n_tiles,) int32, segments inside
    ``pair_data`` (otherwise the kernel fails its launch, and the next
    synchronization raises).  Returns (best_z, best_id) as (n_tiles, TILE²)
    f32 / int32, id -1 = miss."""
    if pair_data.device.type == "cpu":
        return stage_b_plain(pair_data, tile_start, tile_cnt, n_tiles, tx_n)
    dev = pair_data.device
    kernels.require(pair_data, "pair_data", torch.float32, device=dev)
    if pair_data.dim() != 2 or pair_data.shape[1] != 16:
        raise ValueError(f"pair_data: shape {tuple(pair_data.shape)}, expected (P, 16)")
    if pair_data.data_ptr() % 16:
        raise ValueError("pair_data: must be 16-byte aligned (bulk copies)")
    kernels.require(tile_start, "tile_start", torch.int32, (n_tiles,), dev)
    kernels.require(tile_cnt, "tile_cnt", torch.int32, (n_tiles,), dev)
    max_subs = stage_b_max_subs(n_tiles, pair_data.shape[0])
    subs = torch.empty((max_subs, 4), dtype=torch.int32, device=dev)
    work = torch.empty((2,), dtype=torch.int32, device=dev)
    keys = torch.empty((n_tiles, _PX), dtype=torch.int64, device=dev)
    best_z = torch.empty((n_tiles, _PX), dtype=torch.float32, device=dev)
    best_id = torch.empty((n_tiles, _PX), dtype=torch.int32, device=dev)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = _stage_b_lib().gs_stage_b(
        ptr(pair_data), ptr(tile_start), ptr(tile_cnt), ptr(subs), ptr(work), ptr(keys),
        ptr(best_z), ptr(best_id), n_tiles, tx_n, max_subs,
        ctypes.c_void_p(kernels.stream_ptr(pair_data)),
    )
    kernels.check(err, "rasterize_stage_b")
    return best_z, best_id


# ----------------------------------------------------------------------------
# Stage A + stitching
# ----------------------------------------------------------------------------


class Bins(NamedTuple):
    """Stage-A output: the stage-B kernel's inputs plus the image layout."""

    pair_data: torch.Tensor  # (max_pairs, 16) f32, sorted by tile
    tile_start: torch.Tensor  # (n_tiles,) int32
    tile_cnt: torch.Tensor  # (n_tiles,) int32
    n_tiles: int
    tx_n: int
    ty_n: int
    dropped: torch.Tensor  # () int32 pairs beyond max_pairs


@torch.no_grad()
def bin_pairs(v_clip, faces, resolution, max_pairs: int | None = None) -> Bins:
    """Stage A of ``rasterize_tiled`` (JAX :474-536): expand each on-screen
    triangle's bounding tile rectangle into (triangle, tile) pairs with no
    host loop, sort the pairs by tile and locate each tile's segment.  The
    pair buffer holds ``max_pairs`` pairs, by default ``min(F·tiles,
    max(8·F, 4096))`` (JAX :487); pairs beyond it are dropped and counted."""
    h, w = resolution
    if h % TILE or w % TILE:
        raise ValueError(f"binned rasterization needs a multiple of {TILE}, got {h}x{w}")
    dev = v_clip.device
    ty_n, tx_n = h // TILE, w // TILE
    n_tiles = ty_n * tx_n
    f = faces.shape[0]
    if max_pairs is None:
        max_pairs = min(f * n_tiles, max(8 * f, 4096))

    sx, sy, z, _, tri_ok = _tri_screen(v_clip, faces, h, w)
    a, b, c, area2 = _edge_coeffs(sx, sy)
    ok = tri_ok & (area2.abs() > 1e-12)

    def tile_idx(v, n):  # saturating float→int, then clip (JAX astype + clip)
        return torch.clamp(torch.floor(v / TILE), -1, n).long().clamp(0, n - 1)

    smin_x, smax_x = sx.min(-1).values, sx.max(-1).values
    smin_y, smax_y = sy.min(-1).values, sy.max(-1).values
    x0, x1 = tile_idx(smin_x, tx_n), tile_idx(smax_x, tx_n)
    y0, y1 = tile_idx(smin_y, ty_n), tile_idx(smax_y, ty_n)
    off = (smax_x < 0) | (smin_x >= w) | (smax_y < 0) | (smin_y >= h)
    ok = ok & ~off
    rw = x1 - x0 + 1
    counts = torch.where(ok, rw * (y1 - y0 + 1), 0)
    offsets = torch.cumsum(counts, 0)
    total = offsets[-1]
    starts = offsets - counts

    j = torch.arange(max_pairs, device=dev)
    # pair j → triangle: mark segment starts, cumsum to a rank, then map
    # rank → triangle through the compaction of nonempty triangles
    nz = counts > 0
    mark = torch.where(nz, starts.clamp(max=max_pairs), max_pairs)
    ind = torch.zeros(max_pairs + 1, dtype=torch.long, device=dev)
    ind.index_add_(0, mark, torch.ones_like(mark))
    pair_rank = torch.cumsum(ind[:max_pairs], 0) - 1
    order_nz = torch.argsort((~nz).to(torch.int32), stable=True)
    pair_tri = order_nz[pair_rank.clamp(0, f - 1)]
    local = j - starts[pair_tri]
    pw = rw[pair_tri].clamp(min=1)
    ptile = (y0[pair_tri] + local // pw) * tx_n + x0[pair_tri] + local % pw
    ptile = torch.where(j < total, ptile, n_tiles)  # invalid → sentinel bin
    dropped = (total - max_pairs).clamp(min=0).to(torch.int32)

    order = torch.argsort(ptile, stable=True)
    s_tile = ptile[order]
    s_tri = pair_tri[order]
    tids = torch.arange(n_tiles, device=dev)
    tile_start = torch.searchsorted(s_tile, tids)
    tile_end = torch.searchsorted(s_tile, tids, right=True)
    pd = torch.cat(
        [a[s_tri], b[s_tri], c[s_tri], z[s_tri], area2[s_tri, None],
         (s_tri + 1).float()[:, None],
         torch.zeros((max_pairs, 2), dtype=torch.float32, device=dev)],
        dim=1,
    ).contiguous()
    return Bins(pd, tile_start.to(torch.int32).contiguous(),
                (tile_end - tile_start).to(torch.int32).contiguous(),
                n_tiles, tx_n, ty_n, dropped)


def rasterize_tiled(v_clip, faces, resolution, max_pairs: int | None = None) -> Rast:
    """Two-stage binned rasterization (JAX ``rasterize_tiled`` :442): stage A
    :func:`bin_pairs` with a buffer of ``max_pairs``, then stage B
    (:func:`rasterize_stage_b`, the kernel on the card) over each tile's
    whole segment.  Dropped pairs are counted in ``Rast.dropped``."""
    return rasterize_tiled_peel(v_clip, faces, resolution, max_pairs, n_layers=1)[0]


def rasterize_tiled_peel(v_clip, faces, resolution, max_pairs: int | None = None, n_layers: int = 2) -> list:
    """The first ``n_layers`` (1 or 2) layers over one stage A's tile
    segments, as :class:`Rast`: layer 1 from :func:`rasterize_stage_b` (the
    kernel on the card), layer 2 from :func:`stage_b_second` given layer 1's
    winners.  Stage A's dropped pairs are counted once, in layer 1's
    ``dropped``.  The layers equal :func:`rasterize_peel`'s except where two
    candidates' depths tie within rounding (stage B's depth is ``depth_num
    · (1/area)``, the scan's Σ (e_k/area)·z_k)."""
    if n_layers not in (1, 2):
        raise ValueError(f"n_layers {n_layers}: the binned peel has layers 1 and 2")
    h, w = resolution
    bins = bin_pairs(v_clip, faces, resolution, max_pairs)
    args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    with torch.no_grad():
        layers = [rasterize_stage_b(*args)]
        if n_layers == 2:
            layers.append(stage_b_second(*args, layers[0][1]))
    out = []
    for k, (bz, bid) in enumerate(layers):
        best_id = bid.long()
        out.append(_stitch_tiles(torch.where(best_id >= 0, bz, _BIG), best_id, v_clip, faces, h, w,
                                 bins.ty_n, bins.tx_n, dropped=bins.dropped if k == 0 else 0))
    return out


def _stitch_tiles(best_z, best_id, v_clip, faces, h, w, ty_n, tx_n, dropped=0) -> Rast:
    """(n_tiles, TILE²) per-tile winners → image-layout :class:`Rast`."""
    best_z = best_z.reshape(ty_n, tx_n, TILE, TILE).permute(0, 2, 1, 3).reshape(h, w)
    best_id = best_id.reshape(ty_n, tx_n, TILE, TILE).permute(0, 2, 1, 3).reshape(h, w)
    hit = best_id >= 0
    tri_id = torch.where(hit, best_id + 1, 0)
    zbuf = torch.where(hit, best_z, _BIG)
    px, py = _pixel_grid(h, w, v_clip.device)
    with torch.no_grad():
        bary = _recompute_bary(v_clip, faces, tri_id.reshape(-1), px, py, h, w)
    return Rast(tri_id=tri_id, bary=bary.reshape(h, w, 2), zbuf=zbuf, dropped=dropped)


def _recompute_bary(v_clip, faces, tri_id, px, py, h, w):
    """Perspective-correct (b0, b1) for each pixel's selected triangle,
    differentiable w.r.t. ``v_clip``."""
    fid = torch.clamp(tri_id - 1, min=0)
    tri = gather_rows(v_clip, faces[fid])  # (P, 3, 4)
    inv_w = 1.0 / torch.clamp(tri[..., 3], min=_W_EPS)
    sx = (tri[..., 0] * inv_w * 0.5 + 0.5) * w
    sy = (tri[..., 1] * inv_w * 0.5 + 0.5) * h
    a, b, c, area2 = _edge_coeffs(sx, sy)
    e = a * px[:, None] + b * py[:, None] + c  # (P, 3)
    ok = area2.abs() > 1e-6
    sb = e / torch.where(ok, area2, 1.0)[:, None]
    pc = sb * inv_w
    denom = pc.sum(-1, keepdim=True)
    dok = denom.abs() > 1e-8
    pc = pc / torch.where(dok, denom, 1.0)
    one = torch.tensor([[1.0, 0.0, 0.0]], dtype=pc.dtype, device=pc.device)
    pc = torch.where(ok[:, None] & dok, pc, one)
    return pc[:, :2]


def interpolate(attr, rast: Rast, faces, v_clip=None, pos_faces=None):
    """Blend per-vertex attributes (V, C) at each pixel → (H, W, C); zeros at
    background.  With ``v_clip`` the barycentrics are recomputed
    differentiably (gradients reach positions), from the triangles
    ``pos_faces`` (default ``faces``) of ``v_clip``: pass the position
    faces when ``faces`` index another buffer, as UV faces do."""
    h, w = rast.tri_id.shape
    tri_id = rast.tri_id.reshape(-1)
    if v_clip is not None:
        px, py = _pixel_grid(h, w, attr.device)
        b01 = _recompute_bary(v_clip, faces if pos_faces is None else pos_faces, tri_id, px, py, h, w)
    else:
        b01 = rast.bary.reshape(-1, 2)
    b2 = 1.0 - b01.sum(-1, keepdim=True)
    bary = torch.cat([b01, b2], dim=-1)
    fid = torch.clamp(tri_id - 1, min=0)
    av = gather_rows(attr, faces[fid])  # (P, 3, C)
    out = (av * bary[..., None]).sum(dim=1)
    hit = (tri_id > 0)[:, None].to(out.dtype)
    return (out * hit).reshape(h, w, -1)


def bary_screen_derivs(rast: Rast, faces, v_clip):
    """(H, W, 4) = (du/dx, du/dy, dv/dx, dv/dy) of the perspective-correct
    barycentrics (nvdiffrast ``rast_db``)."""
    h, w = rast.tri_id.shape
    tri_id = rast.tri_id.reshape(-1)
    fid = torch.clamp(tri_id - 1, min=0)
    tri = v_clip[faces[fid]]
    inv_w = 1.0 / torch.clamp(tri[..., 3], min=_W_EPS)
    sx = (tri[..., 0] * inv_w * 0.5 + 0.5) * w
    sy = (tri[..., 1] * inv_w * 0.5 + 0.5) * h
    a, b, c, area2 = _edge_coeffs(sx, sy)
    px, py = _pixel_grid(h, w, v_clip.device)
    area_safe = torch.where(area2.abs() > 1e-6, area2, 1.0)[:, None]
    e = a * px[:, None] + b * py[:, None] + c
    sb = e / area_safe
    dsb_dx = a / area_safe
    dsb_dy = b / area_safe
    q = sb * inv_w
    s = q.sum(-1, keepdim=True)
    s = torch.where(s.abs() > 1e-8, s, 1.0)
    dq_dx = dsb_dx * inv_w
    dq_dy = dsb_dy * inv_w
    ds_dx = dq_dx.sum(-1, keepdim=True)
    ds_dy = dq_dy.sum(-1, keepdim=True)
    db_dx = (dq_dx * s - q * ds_dx) / (s * s)
    db_dy = (dq_dy * s - q * ds_dy) / (s * s)
    out = torch.stack([db_dx[:, 0], db_dy[:, 0], db_dx[:, 1], db_dy[:, 1]], dim=-1)
    hit = (tri_id > 0)[:, None].to(out.dtype)
    return (out * hit).reshape(h, w, 4)


def antialias(color, rast: Rast, v_clip, faces):
    """Silhouette antialiasing (nvdiffrast ``antialias`` semantics; JAX
    ``antialias`` :677).  For each horizontal/vertical neighbour pair with
    differing triangle ids, the leading triangle's edge crossing s ∈ [0, 1]
    blends up to half a pixel; s is differentiable w.r.t. ``v_clip``."""
    h, w = rast.tri_id.shape
    tri_id, z = rast.tri_id, rast.zbuf
    ys, xs = _pixel_centers(h, w, color.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    delta = torch.zeros_like(color)
    for axis in (1, 0):
        if axis == 1:
            ia = (slice(None), slice(0, w - 1))
            ib = (slice(None), slice(1, w))
        else:
            ia = (slice(0, h - 1), slice(None))
            ib = (slice(1, h), slice(None))
        id_a, id_b = tri_id[ia], tri_id[ib]
        differs = id_a != id_b
        a_leads = torch.where(id_b == 0, True, torch.where(id_a == 0, False, z[ia] <= z[ib]))
        lead_fid = torch.clamp(torch.where(a_leads, id_a, id_b) - 1, min=0)

        tri = gather_rows(v_clip, faces[lead_fid])
        inv_w = 1.0 / torch.clamp(tri[..., 3], min=_W_EPS)
        sxc = (tri[..., 0] * inv_w * 0.5 + 0.5) * w
        syc = (tri[..., 1] * inv_w * 0.5 + 0.5) * h
        ca, cb, cc, area2 = _edge_coeffs(sxc, syc)
        s_or = torch.sign(area2)[..., None]
        e_a = (ca * px[ia][..., None] + cb * py[ia][..., None] + cc) * s_or
        e_b = e_a + (ca if axis == 1 else cb) * s_or
        al = a_leads[..., None]
        e_lead = torch.where(al, e_a, e_b)
        e_other = torch.where(al, e_b, e_a)

        crossing = (e_lead > 0.0) & (e_other < 0.0)
        denom = e_lead - e_other
        denom = torch.where(denom.abs() > 1e-3, denom, 1.0)
        s_all = torch.where(crossing, e_lead / denom, _BIG)
        s = torch.amin(s_all, dim=-1)
        has_edge = differs & (s <= 1.0)
        s = torch.clamp(torch.where(has_edge, s, 0.5), 0.0, 1.0)[..., None]

        c_a, c_b = color[ia], color[ib]
        c_lead = torch.where(al, c_a, c_b)
        c_other = torch.where(al, c_b, c_a)
        m = has_edge[..., None].to(color.dtype)
        d_other = torch.clamp(s - 0.5, 0.0, 0.5) * m * (c_lead - c_other)
        d_lead = torch.clamp(0.5 - s, 0.0, 0.5) * m * (c_other - c_lead)
        d_a = torch.where(al, d_lead, d_other)
        d_b = torch.where(al, d_other, d_lead)
        if axis == 1:
            delta = delta + F.pad(d_a, (0, 0, 0, 1))
            delta = delta + F.pad(d_b, (0, 0, 1, 0))
        else:
            delta = delta + F.pad(d_a, (0, 0, 0, 0, 0, 1))
            delta = delta + F.pad(d_b, (0, 0, 0, 0, 1, 0))
    return color + delta
