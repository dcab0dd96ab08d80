"""The (view × band) banded render and pixel-sharded shading over a process
group (PyTorch twin of ``gshell_tpu/parallel/spatial.py``).

The image of every view splits into horizontal row bands; a (view, band)
pair is a cell.  JAX puts one cell on each device of a ("view", "band")
mesh.  Torch has no virtual devices, so here a rank holds several cells:
rank r of W renders the cells c = v·n_band + b with c mod W = r.  With
no process group one process renders them all (the local mode), and at
W = n_view·n_band each rank renders one cell, as JAX does.  Every rank
computes the replicated work (the mesh, the shadow field, the losses)
itself; the cells' crops are put together by :func:`sharding.stitch`.

JAX's ``make_row_sharded_render`` and ``shard_image_rows`` have no caller
in the repository; their part, a band's rows and its viewport, is
:func:`render_batch_banded`'s cell loop and :func:`band_mvp`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .sharding import all_reduce_, slot_range, stitch, world

COUNTERS = ("n_raster_dropped", "n_px_dropped", "n_px_dropped_second")


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """``n_view`` × ``n_band`` cells over the ranks of ``group`` (``None``:
    one process renders every cell)."""
    n_view: int
    n_band: int
    group: object = None

    def cells(self) -> list:
        """This rank's cells, as (view, band)."""
        rank, size = world(self.group)
        n = self.n_view * self.n_band
        if size > n:
            raise ValueError(f"{size} ranks for {n} cells: a rank would render nothing")
        return [divmod(c, self.n_band) for c in range(n) if c % size == rank]


def band_mvp(mvp: torch.Tensor, y0, h_band: int, h_full: int) -> torch.Tensor:
    """The MVP that renders image rows [y0, y0 + h_band) of an h_full-row
    image as an h_band-row image with the same pixel geometry: the
    rasterizer maps ndc_y → (ndc_y·½ + ½)·h, so the band needs the clip-space
    change y' = a·y + b·w with a = h/h', b = (h − h' − 2·y0)/h'."""
    a = h_full / h_band
    b = (h_full - h_band - 2.0 * y0) / h_band
    out = mvp.clone()
    out[1] = a * mvp[1] + b * mvp[3]
    return out


def render_batch_banded(render_fn: Callable, draws, mvp, campos, background, resolution, grid: CellGrid,
                        pad: int = 16) -> dict:
    """Render ``mvp.shape[0] == grid.n_view`` views in (view, band) cells →
    the buffers of every view, (B, H, W, C), replicated on every rank.

    Each cell renders its band with ``pad`` halo rows above and below, over
    a background whose edge rows are repeated into the halo, so that the
    windowed image ops (antialias, the bilateral denoiser's radius 11, the
    jitter taps) see rendered context; the halo is cropped before the
    stitch.  ``render_fn(cell_draws, band_mvp, campos, bg_band,
    (h_band + 2·pad, W)) → buffers``; cell (v, b) draws from
    ``draws.child(f"view{v}").fork(f"band{b}")``, forked for every cell on
    every rank in the same order.  ``visible_vert_mask`` comes back (1, V),
    the OR over all cells; each of the counters (``COUNTERS``) (1,), summed
    over all cells (0 where no cell counts it); any other buffer must be an
    image buffer of the band's height.

    Known edge effect, as in JAX: the top and bottom bands render halo rows
    outside the image, where the unbanded render pads with zeros, so the
    windowed ops differ slightly at image rows 0 and H − 1."""
    nv, nb = grid.n_view, grid.n_band
    h, w = resolution
    if mvp.shape[0] != nv:
        raise ValueError(f"{mvp.shape[0]} views for {nv} view cells: the batch must equal n_view")
    if h % nb:
        raise ValueError(f"{h} image rows do not split into {nb} bands")
    hb = h // nb
    hb2 = hb + 2 * pad
    cells = {(v, b): draws.child(f"view{v}").fork(f"band{b}") for v in range(nv) for b in range(nb)}
    bg_pad = torch.cat([background[:, :1].expand(-1, pad, -1, -1), background,
                        background[:, -1:].expand(-1, pad, -1, -1)], 1)

    crops, vis = {}, None
    counters = {name: torch.zeros((), dtype=torch.int64, device=mvp.device) for name in COUNTERS}
    for v, b in grid.cells():
        m = band_mvp(mvp[v], b * hb - pad, hb2, h)
        bufs = render_fn(cells[(v, b)], m, campos[v], bg_pad[v, b * hb:b * hb + hb2], (hb2, w))
        for name, val in bufs.items():
            if name == "visible_vert_mask":
                vis = val if vis is None else vis | val
            elif name in COUNTERS:
                counters[name] = counters[name] + torch.as_tensor(val, device=mvp.device).to(torch.int64)
            else:
                if val.ndim != 3 or val.shape[0] != hb2:
                    raise ValueError(f"banded render: buffer {name!r} of shape {tuple(val.shape)} is not an "
                                     f"image of the band's height {hb2}")
                crops.setdefault(name, {})[(v, b)] = val[pad:pad + hb]

    out = {}
    for dtype in dict.fromkeys(next(iter(c.values())).dtype for c in crops.values()):
        names = [k for k, c in crops.items() if next(iter(c.values())).dtype == dtype]
        full = [_assemble(crops[k], nv, nb) for k in names]
        flat = stitch(torch.cat([f.reshape(-1) for f in full]), grid.group)
        for k, f, part in zip(names, full, flat.split([f.numel() for f in full])):
            out[k] = part.view_as(f)
    out["visible_vert_mask"] = all_reduce_(vis.clone(), grid.group, "max")[None]
    for name, val in counters.items():
        out[name] = all_reduce_(val.reshape(1).clone(), grid.group)
    return out


def _assemble(pieces: dict, nv: int, nb: int) -> torch.Tensor:
    """(nv, nb·hb, W, C): the pieces this rank rendered, zeros elsewhere."""
    like = next(iter(pieces.values()))
    zeros = torch.zeros_like(like)
    return torch.stack([torch.cat([pieces.get((v, b), zeros) for b in range(nb)]) for v in range(nv)])


def pixel_sharded_shade(env_shade_fn: Callable, group=None):
    """Wrap a flattened-pixel shading call (``ops.shade.env_shade``) so that
    each rank shades its contiguous share of the P pixel rows and the
    stitch gives every rank all of them; the light and the other keyword
    arguments are replicated.  Each rank draws for its own rows, so the
    estimate agrees with the unsharded call in expectation (JAX's shards
    draw on lanes of their own too)."""

    def wrapped(draws, mask, ro, gb_pos, gb_normal, view_pos, kd, ks, light, **kw):
        rank, size = world(group)
        p = gb_pos.shape[0]
        lo, hi = slot_range(p, rank, size)
        rows = [t[lo:hi] for t in (mask, ro, gb_pos, gb_normal, view_pos, kd, ks)]
        out = env_shade_fn(draws, *rows, light, **kw)
        put = lambda t: torch.cat([t.new_zeros((lo,) + t.shape[1:]), t, t.new_zeros((p - hi,) + t.shape[1:])])
        return type(out)(*(stitch(put(t), group) for t in out))

    return wrapped
