#!/usr/bin/env python3
"""Device time of the port's two hand-written kernels at the working point,
on one CUDA GPU.

Builds ``chip_smoke.py``'s working point (512², tet grid 64, the pretrained
SDF at state step 1000), then times, on the inputs the train step gives
them:

  * raster stage B on each view's pair list, and where its time goes: the
    same call on the same pair list with every triangle moved off its tiles
    (``c`` of each edge set to -3e38 with the orientation's sign, so the
    kernel's per-warp cull drops every pair: schedule, bulk copies, folds
    and barriers, no pixel test) and on no pairs at all (the three launches
    and the output writes);
  * the bilateral stencil at r = 11, sigma = 2 on the first view's guides,
    3 channels (diffuse) and 6 (diffuse and specular, as the renderer
    calls it), forward and transposed (``denom_from_tap``).

``device_ms`` is the time per call on the card: 20 calls captured in a CUDA
graph, the median of 7 replays, so the host's launch cost is not in it.
``eager_ms`` is one call from Python between two CUDA events (median of 20):
what the train step pays, host included.  ``bound_ms`` is ``chip_smoke.py``'s
bound for the same work.  Every kernel result is first held to its plain
version (stage B: ids and hit depths bit-identical; stencil: max |err|
printed).

To time an earlier commit's kernels beside these, run that checkout's own
``chip_smoke.py`` in the same chip call and compare its printed times.

Usage: ``python3 tools/torch_kernel_bench.py`` from the repository root.
Prints JSON lines, the card's name and power limit last.
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gshell_tpu_torch.ops import denoiser as dn  # noqa: E402
from gshell_tpu_torch.ops import math as gm  # noqa: E402
from gshell_tpu_torch.ops import rasterize as rz  # noqa: E402
from gshell_tpu_torch.utils import kernels  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timings(fn) -> dict:
    return {"device_ms": chip_smoke._device_ms(fn), "eager_ms": chip_smoke._median_ms(fn, n=20)}


def stage_b_cases(bins) -> dict:
    """The view's pair list, the same list culled off every tile, and no
    pairs: name -> stage-B arguments."""
    full = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    culled = bins.pair_data.clone()
    culled[:, 6:9] = -3e38 * torch.sign(culled[:, 12:13])
    return {"full": full,
            "culled": (culled,) + full[1:],
            "empty": (bins.pair_data, bins.tile_start, torch.zeros_like(bins.tile_cnt)) + full[3:]}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = chip_smoke.card_name()
    kernels.lib()
    rec, state, draws, target = chip_smoke.working_point(dev)
    res = chip_smoke.RES
    with torch.no_grad():
        mesh, faces_c, _, n_faces, v_nrm, _ = rec.geo.extract(state.params_geo)
        for v in range(chip_smoke.BATCH):
            v_clip = gm.xfm_points(mesh.verts, target["mvp"][v])
            bins = rz.bin_pairs(v_clip, faces_c, (res, res))
            runs = {}
            for name, a in stage_b_cases(bins).items():
                kz, kid = rz.rasterize_stage_b(*a)
                pz, pid = rz.stage_b_plain(*a)
                hit = pid >= 0
                if not torch.equal(kid, pid) or not torch.equal(kz[hit], pz[hit]):
                    raise RuntimeError(f"stage B ({name}) disagrees with the plain version")
                if name != "full" and bool(hit.any()):
                    raise RuntimeError(f"stage B ({name}) covers pixels")
                runs[name] = timings(lambda a=a: rz.rasterize_stage_b(*a))
            n_pairs = int(bins.tile_cnt.sum())
            box_px, inside_px = chip_smoke.stage_b_pair_pixels(bins, v_clip, faces_c, res)
            cnt = bins.tile_cnt.float()
            emit(kernel="rasterize_stage_b", view=v, pairs=n_pairs, tiles=bins.n_tiles,
                 sub_segments=int(rz.stage_b_schedule(bins.tile_start, bins.tile_cnt).shape[0]),
                 pair_px=n_pairs * 256, pair_px_box=box_px, pair_px_inside=inside_px,
                 pairs_per_tile={"max": int(cnt.max()), "mean": float(cnt.mean()),
                                 "p99": float(torch.quantile(cnt, 0.99))},
                 bound_ms=chip_smoke.stage_b_bound(n_pairs, bins.n_tiles, box_px, inside_px)[0],
                 runs=runs, card=smi)

        bufs = chip_smoke.probe_view(rec, state, draws, target, mesh, faces_c, v_nrm)
        nrm = bufs["normal"][..., 0:3].contiguous()
        zdz = bufs["z_grad"][..., 0:2].contiguous()
        diffuse = bufs["diffuse_light"][..., 0:3].contiguous()
        both = torch.cat([diffuse, bufs["specular_light"][..., 0:3]], -1).contiguous()
        for from_tap in (False, True):
            errs, runs = {}, {}
            for c, col in ((6, both), (3, diffuse)):
                kc, kw = dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11, from_tap)
                pc, pw = dn.bilateral_plain(col, nrm, zdz, 2.0, 11, from_tap)
                errs[c] = max(float((kc - pc).abs().max()), float((kw - pw).abs().max()))
                runs[c] = timings(lambda col=col: dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11, from_tap))
            emit(kernel="bilateral_accumulate", denom_from_tap=from_tap, r=11, res=res,
                 max_abs_err=errs, bound_ms={c: chip_smoke.stencil_bound(res, res, 11, c)[0] for c in (3, 6)},
                 runs=runs, card=smi)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
