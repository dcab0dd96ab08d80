#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gshell_tpu_torch) on one GPU.

Runs, in order:
  1. environment: requires a CUDA device; prints torch / CUDA versions and
     the card's name and power limit (nvidia-smi);
  2. build: compiles the hand-written kernels (csrc/*.cu) from this checkout;
  3. raster stage B: kernel vs plain PyTorch version on the pair lists of
     the real pretrained mesh at 512x512, both views (with each view's
     pairs-per-tile max, mean and p99), and on a synthetic mesh with one
     crowded tile, exact depth ties and +-0.0 depths — ids identical on every
     pixel, z identical where hit;
  4. bilateral denoiser: kernel vs plain version at 512x512, r = 11, sigma = 2,
     on the normals and (z, dz) of a real rendered view, forward and
     transposed (denom_from_tap) stencils, 3 colour channels and 6 (diffuse
     and specular in one launch, as the renderer calls it), rtol 1e-5 /
     atol 1e-6;
     Then the gathers' backward (csrc/gather_rows.cu) against aten's
     index_put_(accumulate=True) on the shapes of ``tets128_train``'s nine
     gather sites (rows, width, zero-row share and longest run of one index
     as a traced step has them): each row within 1e-6 of its summed
     magnitudes, the kernel's own count of scattered rows exact, both timed,
     with the bound; a ``{"gather_backward": ...}`` line.  Then the MC
     shade's kernel pair (csrc/mc_shade.cu) against the eager walk at both
     reconstruction cells' shapes (131,072 slots x 64 samples; 524,288 x
     576, held on a slice of rows): the forward and each input's cotangent,
     both passes timed, with the bound (``MC_OPS``); a ``{"mc_shade":
     ...}`` line.
  5. a small train step (tet grid 16, 64x64) on the card against the same
     step on the CPU, where both kernels take their plain versions: same
     state, same draws; loss to rtol 1e-3, gradient cosines >= 0.98;
  6. the slice: Reconstructor at the working point (512², tet grid 64,
     n_samples 8, batch 2, MLP SDF + eikonal 16384, mesh-splat shadows,
     shade_budget 0.5, denoiser on, default hash grid), 1000 SDF pretrain
     steps, state step 1000 (shadows and sigma = 2 live), three train steps
     on a synthetic disk target; losses finite, faces > 0, no raster drops,
     and exactly 2 stage-B launches (three CUDA kernels each: schedule, test,
     unpack) and 4 denoiser launches per step, and the MC shade's;
  7. the command-line path at the full width of the skirt quality config
     (configs/synthetic_skirt_512_shadowed.json: 512², tet grid 96,
     n_samples 8, batch 2, 64 shadowed ground-truth views): the port's
     generator writes the skirt OBJ; ``train_gshell.main`` trains 2
     iterations (save_interval 2), then resumes from that snapshot to 4;
     ``eval_reconstruction.main`` measures 16 held-out views and the
     Chamfer-L2.  Losses, PSNR and Chamfer finite, faces > 0, no raster
     drops, the OBJ has faces, the resumed run starts at iteration 2, and
     the raster, stencil and MC shade kernels launched in the ground-truth
     pre-render, in training and in eval, and no MC shade walk eager.  Each
     kernel's first and last launch of each entry point (a ground-truth
     view, the last train step, the last eval view) is held against its
     plain version on the inputs that path gave it, as in phases 3 and 4
     (the MC shade's forward and reverse launches on a window of
     ``MC_TAP_ROWS`` rows from the first live one, against the eager walk,
     to ``MC_TAP_RTOL``).  Prints the pre-render time per view, s/step and peak memory
     at grid 96, n_valid_tets / n_faces, the splat coverage, and the eval's
     time, PSNR and Chamfer, each beside the card.
  8. the diffusion path at the full width of configs/diffusion_upper_occgrid.json
     (the UNet3D defaults: 411M parameters, grids 128³×4 and 256³, tet
     resolution 64), through the port's entry points into the gitignored
     ``out/chip_smoke/diffusion/``: four synthetic open shapes are baked
     (``bake_grids.main``) and ``decode(bake(·))`` is held against the
     extractor (equal faces, vertices within 2e-2); a small UNet3D is held
     card vs CPU (``DIFF_SMALL_LIMITS``); ``main_diffusion.main`` trains 3
     iterations at batch 1 × grad-acc 2 in IEEE float32 with a snapshot, a
     second call resumes at the saved step, a third samples 10 DDIM steps
     with the EMA weights; ``eval_gmeshdiffusion.main`` decodes the sample
     and a baked grid, which must give the round trip's face count.  Prints
     s/step, peak memory, the snapshot, the analytic FLOPs and TFLOP/s, and
     a ``{"diffusion": ...}`` JSON line.  This path launches neither kernel.
  9. G-Shell on FlexiCubes at the full width of configs/deepfashion_mc_80.json
     (voxel 80, 1024², n_samples 24, batch 2; view_batch_mode "map", so no
     view is recomputed in the backward): train 2 + 1 resumed, eval 4 views; per step the non-finite
     gradient elements and the SDF MLP's gradient norm (> 0); the step's
     layers; both kernels held and timed at 1024²; a ``{"flexicubes": ...}``
     line.
 10. the second surface layer: the skirt config at full width with
     ``layers: 2``, ``use_img_2nd_layer``, ``use_depth`` and
     ``use_depth_2nd_layer`` (16 two-layer ground-truth views, train 2 + 1
     resumed, eval 4 views), both kernels held as in phase 7; on one real
     view of the trained mesh the scan oracle (``rasterize_peel``) against
     the stage-B kernel's first layer and the binned second layer (taken
     over the same bins, given the kernel's winners), every differing pixel
     a depth tie within rounding; the one-layer and two-layer binned passes,
     the second layer's own pass and the scan timed; a
     ``{"second_layer": ...}`` line.
 11. textured meshes: the skirt config at full width with ``spp: 2`` and
     ``denoiser_demodulate: false`` (16 ground-truth views, 2 iterations:
     stage B at 1024², the 3-channel stencil forward and transposed at
     1024², held as in phase 7); the state's material given a kd that
     varies across the skirt, then a resumed call with ``--bake-texture
     1024`` (unwrap on the host, ``render_uv`` on the card) writes the four
     asset files; the asset is loaded back (OBJ, MTL, PNGs,
     ``merge_materials``) and rendered on a 512² view under ``kd`` and
     ``pbr`` (both kernels, held) and ``normal`` and ``ks``: the baked kd
     scores at least 20 dB PSNR against the neural kd, the atlas flipped in
     v at least 3 dB less; a ``{"textured": ...}`` line.
 12. the other geometry fields and shadow sources: (a) the skirt config with
     a direct per-vertex SDF (16 ground-truth views, train 2 + 1 resumed,
     eval 4 views; the snapshot holds ``sdf`` and no ``sdf_net``, the
     eikonal is 0); (b) the skirt config with an mSDF MLP, 2 iterations,
     the share of lattice vertices it keeps at init and after; (c) phase
     9's FlexiCubes config with a direct SDF (8 views, 2 iterations, eval 4
     views; both kernels held and timed at 1024², the step beside phase
     9's); each entry point counted, both kernels' first and last launches
     held; (d) at phase 6's working point, one step under the legacy
     template-SDF occluder with the swept field and with the marcher, the
     share of surface rays each blocks (strictly between 0 and 1), the
     marcher card against CPU (nearest exactly, trilinear to
     ``MARCH_TRILINEAR_MAX_DIFF``), builds and lookups timed; a
     ``{"fields": ...}`` line.
 13. the distributed paths over torch.distributed: (a) ``main_diffusion
     --multihost`` at phase 8's full width over NCCL at world size 1, one
     step against the same step without a group (deterministic cuDNN; loss
     and gradient norm bit for bit), then ``DiffusionTrainer(mesh=)`` on
     two gloo ranks sharing the card (base 32, dropout 0, grid 32, batch
     2 x 2) against one process; (b) ``Reconstructor(spatial=(2, 4))`` from
     phase 7's state at the skirt config's full width, 2 steps in one
     process holding all 8 cells of 160x512 (8 stage-B and 16 stencil
     launches a step, the first and last held, both kernels timed at
     160x512), banded against unbanded pixels (``BAND_FLOOR_RATIO``), then
     on two gloo ranks of 4 cells each (subprocesses: ``python3
     chip_smoke.py --rank-worker ...``; a rank that fails fails the run),
     the ranks' parameters bit for bit, the first step's loss against the
     one process to ``DIST_RTOL`` and its gradient norms per parameter
     group to ``DIST_GRAD_RTOL``; (c) phase 9's FlexiCubes state with
     spatial (2, 2), one step of 4 cells of 544x1024, both kernels held and
     timed there; a ``{"distributed": ...}`` line.
 14. the measurement entry points, each ``main`` in process with its
     standard output captured (one JSON line, the JAX twin's metric
     string): ``bench --one 512,64,8,2`` counted and tapped as phase 7's
     entry points (state steps 0 to 21 from the pretrained state; every
     timed step launches stage B BATCH times and the stencil 2 * BATCH
     times; the first and last launches held), its step beside phase 6's
     at state step 1000; ``bench_extract 64`` and ``80`` (FlexiCubes at
     min(RES, 80)) and ``bench_diffusion 128 1 3``, which launch neither
     kernel; a ``{"bench": ...}`` line.

Prints a JSON line of per-kernel results (with ``bound_ms``, the least time
the card could take for the same work, see ``_bound_ms``), the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit, no
ok line).  Usage: ``python3 chip_smoke.py`` from the repository root.
"""
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

RES, GRID, SPP, BATCH = 512, 64, 8, 2
N_STEPS = 3
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_CONFIG = os.path.join(ROOT, "configs", "synthetic_skirt_512_shadowed.json")
CLI_OUT = os.path.join(ROOT, "out", "chip_smoke")  # gitignored


# Peak rates of one NVIDIA H100 SXM at its 700 W limit: 67 TFLOP/s FP32
# outside the tensor cores counts an FMA as 2 operations, i.e. 33.5 T FP32
# instructions/s (132 SMs x 128 lanes x 1.98 GHz); the special-function units
# do 16 operations per SM per clock (4.2 T/s); HBM3 moves 3.35 TB/s.
FP32_INSTR_PER_S = 67e12 / 2
MUFU_PER_S = 132 * 16 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# Least FP32 instructions per unit of work, without fast math and without
# FMA contraction (--fmad=false), counted from the kernels' arithmetic.
# Stencil, per in-image tap: normal dot 5, clamp 2, ^128 7, |dz| and
# dz*dist and max 3, division 1, exp 1, weight product 2, and a product and
# a sum per accumulator (C colours + the weight); plus ex2 and rcp on the
# special-function units.  Every in-image tap is needed, whatever its
# weight: a zero weight times a non-finite colour or depth is NaN in the
# plain version.  Stage B, only the pixels of each pair's triangle
# bounding box within its tile (a pixel outside it cannot be covered): one
# that all three edges hold needs the three edge values (4 each), the depth
# (6), the tests and the select; any other needs at least one edge value
# and its test.
STENCIL_MUFU_PER_TAP = 2
STAGE_B_INSTR_INSIDE = 25
STAGE_B_INSTR_OUTSIDE = 5


def stencil_instr_per_tap(channels: int) -> int:
    return 21 + 2 * (channels + 1)


def _bound_ms(instr: float, bytes_moved: float, mufu: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    the operations over their peak rate."""
    t_ops = max(instr / FP32_INSTR_PER_S, mufu / MUFU_PER_S) * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stencil_taps(h: int, w: int, r: int) -> int:
    """In-image taps of the (2r+1)² stencil over an h×w image."""
    span = lambda n: sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))
    return span(h) * span(w)


def stencil_bound(h: int, w: int, r: int, channels: int):
    taps = stencil_taps(h, w, r)
    bytes_moved = 4 * h * w * ((channels + 3 + 2) + (channels + 1))  # in: col nrm zdz; out: acc
    return _bound_ms(taps * stencil_instr_per_tap(channels), bytes_moved, taps * STENCIL_MUFU_PER_TAP)


def stage_b_pair_pixels(bins, v_clip, faces, res):
    """What stage B must test on this view (``res``: a side, or (h, w)):
    (pixels of each pair's triangle bounding box within its tile, those of
    them inside all three edges), summed over the pairs."""
    import torch

    from gshell_tpu_torch.ops import rasterize as rz

    h, w = (res, res) if isinstance(res, int) else res
    sx, sy = rz._tri_screen(v_clip, faces, h, w)[:2]
    dev = bins.pair_data.device
    cnt = bins.tile_cnt.long()
    total = int(cnt.sum())
    tiles = torch.repeat_interleave(torch.arange(bins.n_tiles, device=dev), cnt)
    rows = torch.repeat_interleave(bins.tile_start.long() - (torch.cumsum(cnt, 0) - cnt), cnt) + \
        torch.arange(total, device=dev)
    lin = torch.arange(rz.TILE * rz.TILE, device=dev)
    box = inside = 0
    for lo in range(0, total, 8192):
        s, t = bins.pair_data[rows[lo:lo + 8192]], tiles[lo:lo + 8192]
        f = s[:, 13].long() - 1
        px = ((t % bins.tx_n)[:, None] * rz.TILE + lin % rz.TILE).float() + 0.5
        py = ((t // bins.tx_n)[:, None] * rz.TILE + lin // rz.TILE).float() + 0.5
        in_box = ((px >= sx[f].min(-1).values[:, None]) & (px <= sx[f].max(-1).values[:, None])
                  & (py >= sy[f].min(-1).values[:, None]) & (py <= sy[f].max(-1).values[:, None]))
        held = in_box
        for k in range(3):
            e = (s[:, k:k + 1] * px + s[:, 3 + k:4 + k] * py + s[:, 6 + k:7 + k]) * torch.sign(s[:, 12:13])
            held = held & (e >= 0.0)
        box += int(in_box.sum())
        inside += int(held.sum())
    return box, inside


def stage_b_bound(n_pairs: int, n_tiles: int, box_px: int, inside_px: int):
    bytes_moved = 64 * n_pairs + 8 * n_tiles + 8 * 256 * n_tiles  # pairs, segments; z and id out
    instr = inside_px * STAGE_B_INSTR_INSIDE + (box_px - inside_px) * STAGE_B_INSTR_OUTSIDE
    return _bound_ms(instr, bytes_moved)


def _device_ms(fn, k: int = 20) -> float:
    """Time per call on the card: ``k`` calls captured in a CUDA graph, the
    median of 7 replays, so the host's launch cost is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / k)
    return sorted(times)[3]


def time_stage_b(bins, v_clip, faces, res, label: str, smi: str) -> dict:
    """Stage B on one view's pairs: device ms (graph replay), ms called
    from Python, the plain version's ms, and the bound from the pixels this
    view's pairs must test."""
    from gshell_tpu_torch.ops import rasterize as rz

    args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    n_pairs = int(bins.tile_cnt.sum())
    box_px, inside_px = stage_b_pair_pixels(bins, v_clip, faces, res)
    out = {"ms": _device_ms(lambda: rz.rasterize_stage_b(*args)),
           "eager_ms": _median_ms(lambda: rz.rasterize_stage_b(*args)),
           "plain_ms": _median_ms(lambda: rz.stage_b_plain(*args)),
           "pairs": n_pairs, "pair_px_box": box_px, "pair_px_inside": inside_px}
    out["bound_ms"], out["bound_by"] = stage_b_bound(n_pairs, bins.n_tiles, box_px, inside_px)
    shape = f"{res}²" if isinstance(res, int) else f"{res[0]}x{res[1]}"
    print(f"stage B at {shape} ({label}): {n_pairs} pairs, {n_pairs * 256} pair-pixels, "
          f"{box_px} in the triangles' boxes, {inside_px} inside all three edges; kernel {out['ms']:.4f} ms "
          f"on the card ({out['eager_ms']:.4f} ms called from Python), plain {out['plain_ms']:.4f} ms, "
          f"bound {out['bound_ms']:.5f} ms ({out['bound_by']})  [{smi}]")
    return out


def time_stencil(col, nrm, zdz, smi: str) -> dict:
    """The forward stencil (r = 11, sigma 2) on one view's guides: device ms,
    ms called from Python, the plain version's ms and the bound."""
    from gshell_tpu_torch.ops import denoiser as dn

    h, w, c = col.shape
    out = {"ms": _device_ms(lambda: dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11), k=5),
           "eager_ms": _median_ms(lambda: dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11)),
           "plain_ms": _median_ms(lambda: dn.bilateral_plain(col, nrm, zdz, 2.0, 11))}
    out["bound_ms"], out["bound_by"] = stencil_bound(h, w, 11, c)
    print(f"denoiser at {h}x{w}, r=11, C={c}: kernel {out['ms']:.4f} ms on the card "
          f"({out['eager_ms']:.4f} ms called from Python), plain {out['plain_ms']:.4f} ms, "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']})  [{smi}]")
    return out


# The gather sites of one ``tets128_train`` step whose backward the kernel
# takes (the attribution of tools/torch_gather_attrib.py on the card): name,
# calls a step, rows a call, row width, source rows, zero-row share, longest
# run of one index (all zero rows), dtype.  The source rows are the
# lattice's (129³ + 1) and the light's (512 × 1024) where they are known,
# else a round number near the extraction's vertex and face buffers: they
# set only the zeroing's share of the time.
GATHER_SITES = (
    ("face_normals (ops/mesh_ops.py)", 15, 393_216, 3, 200_000, 0.8751, 253_468, "f32"),
    ("cut corners cattr[corners] (geometry/gshell_tets.py)", 1, 1_572_864, 5, 196_609, 0.9968, 988_504, "f32"),
    ("antialias v_clip[faces[lead_fid]] (ops/rasterize.py)", 8, 784_896, 4, 200_000, 0.9358, 237_293, "f32"),
    ("interpolate attr[faces[fid]] (ops/rasterize.py)", 4, 786_432, 11, 200_000, 0.8996, 238_067, "f32"),
    ("_recompute_bary v_clip[faces[fid]] (ops/rasterize.py)", 4, 786_432, 4, 200_000, 0.8996, 238_067, "f32"),
    ("geometric normal fn[fid] (render/render.py)", 4, 262_144, 3, 300_000, 0.9574, 238_066, "f32"),
    ("crossing-edge ends pos_p[ev] (geometry/gshell_tets.py)", 2, 196_608, 3, 2_146_690, 0.5112, 100_620, "f32"),
    ("crossing-edge ends msdf_p[ev] (geometry/gshell_tets.py)", 2, 196_608, 1, 2_146_690, 0.6435, 100_620, "f32"),
    ("light lookup lp[ly, lx] (ops/shade.py)", 16, 1_048_576, 4, 512 * 1024, 0.8532, 956, "bf16"),
)


def gather_site_inputs(rows, width, n, zero_share, run, dtype, seed, dev):
    """A site's gradient (rows, width) and index (rows,): ``run`` rows on one
    sentinel source row with zero gradient, more zero rows at random to the
    site's share, the rest random rows and indices, in random order (runs
    of zero rows broken up, the kernel's worst case)."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    idx = torch.randint(0, n, (rows,), generator=gen, device=dev)
    g = torch.randn((rows, width), generator=gen, device=dev)
    zero = torch.rand(rows, generator=gen, device=dev) < (zero_share * rows - run) / max(rows - run, 1)
    zero[:run] = True
    idx[:run] = n - 1
    g[zero] = 0.0
    perm = torch.randperm(rows, generator=gen, device=dev)
    g, idx = g[perm].contiguous(), idx[perm].contiguous()
    return (g.bfloat16() if dtype == "bf16" else g), idx


def gather_bound_ms(rows, width, n, live, elem):
    """Bytes: the gradient and the index read once, the zeroed gradient of
    the source written once, each live row's atomics (4 bytes an element)."""
    return (rows * (width * elem + 8) + n * width * 4 + live * width * 4) / HBM_BYTES_PER_S * 1e3


def gather_backward_check(smi: str) -> dict:
    """The gathers' backward kernel held against aten's and timed on each
    site's shapes; ms a step summed over the sites' calls."""
    import torch

    from gshell_tpu_torch.ops import gather as ga

    dev = torch.device("cuda:0")
    sites, k_step, a_step, b_step = [], 0.0, 0.0, 0.0
    for i, (name, calls, rows, width, n, zero_share, run, dtype) in enumerate(GATHER_SITES):
        g, idx = gather_site_inputs(rows, width, n, zero_share, run, dtype, i, dev)
        live = int((g != 0).any(1).sum())
        aten = lambda: torch.zeros((n, width), dtype=g.dtype, device=dev).index_put_((idx,), g, accumulate=True)
        want = aten().float()
        scale = torch.zeros((n, width), device=dev).index_put_((idx,), g.float().abs(), accumulate=True)
        s0 = ga.gather_stats()
        got = ga.scatter_rows(g, idx, n).float()
        s1 = ga.gather_stats()
        err = torch.linalg.vector_norm(got - want, dim=1)
        room = 1e-6 * torch.linalg.vector_norm(scale, dim=1)
        if dtype == "bf16":
            room = room + 2.0 ** -7 * torch.linalg.vector_norm(want, dim=1)
        worst = float((err / torch.clamp(room, min=1e-30)).max())
        if worst > 1.0 or s1["rows_scattered"] - s0["rows_scattered"] != live \
                or s1["rows_seen"] - s0["rows_seen"] != rows:
            raise RuntimeError(f"gather backward at {name}: error {worst:.3g} of its room, scattered "
                               f"{s1['rows_scattered'] - s0['rows_scattered']} of {live} live rows")
        k_ms = _median_ms(lambda: ga.scatter_rows(g, idx, n))
        a_ms = _median_ms(aten)
        bound = gather_bound_ms(rows, width, n, live, 2 if dtype == "bf16" else 4)
        k_step, a_step, b_step = k_step + calls * k_ms, a_step + calls * a_ms, b_step + calls * bound
        sites.append({"site": name, "calls": calls, "rows": rows, "width": width, "dtype": dtype,
                      "zero_share": 1 - live / rows, "kernel_ms": k_ms, "aten_ms": a_ms, "bound_ms": bound,
                      "share_of_bound": bound / k_ms, "err_of_room": worst})
        print(f"gather backward, {name}: {rows} rows x {width} {dtype}, {1 - live / rows:.4f} zero; kernel "
              f"{k_ms:.4f} ms (zeroing included), aten {a_ms:.3f} ms, bound {bound:.4f} ms "
              f"({100 * bound / k_ms:.1f} %); error {worst:.3g} of its room  [{smi}]")
    print(f"gather backward a tets128_train step ({sum(s['calls'] for s in sites)} calls): kernel {k_step:.3f} ms, "
          f"aten {a_step:.2f} ms, bound {b_step:.3f} ms  [{smi}]")
    return {"sites": sites, "kernel_ms_per_step": k_step, "aten_ms_per_step": a_step, "bound_ms_per_step": b_step,
            "card": smi}


# The MC shade's walk in the reconstruction cells: cell, shade slots (pixel
# rows), samples per side, mc_block, rows held against the eager walk (the
# eager walk at 1024² takes ~9 s a view, so a slice of the rows there).
MC_SHADE_CELLS = (
    ("tets128_train", 131_072, 8, 8, 131_072),
    ("flexi80_train", 524_288, 24, 8, 32_768),
)
# Live slots of a compacted view (shade_budget 0.5): 19.6 % in tets128_train,
# 20.0 % in flexi80_train (shade_stats() over 5 steps on an NVIDIA H100).
MC_SHADE_FG_SHARE = 0.2
# The least arithmetic of the walk (bsdf pbr), a live pixel row and a sample
# by the lobe its BSDF sample takes: (FP32 instructions, special-function
# operations), the means over 4096 rows x 64 samples that
# tools/mc_shade_ops.cpp counts by running csrc/mc_shade.cuh's own
# arithmetic with a counting float (adds, products and FMAs; a division,
# square root or transcendental one special-function operation and no
# more; a sample along the branches it takes, less the sample of the lobe
# it does not take; the row's part once a row).  The reverse repeats the
# sample's forward.
MC_OPS = {"fwd": {"row": (109.6, 21.9), "cosine": (378.5, 56.0), "ggx": (425.5, 61.0)},
          "bwd": {"row": (352.2, 44.8), "cosine": (895.1, 98.5), "ggx": (1012.8, 105.1)}}


def mc_shade_inputs(p, n, block, seed, dev):
    """(walk, mask, tensors) of one ``env_shade`` call at ``p`` slots and n²
    samples: rows facing the camera (roughness from 0.1: below it the eager
    walk's own cotangent is not finite on a few rows), the foreground first
    as the compaction leaves it, the cells' 512² light and a 65³ shadow
    field of a sphere's shell."""
    import numpy as np
    import torch

    from gshell_tpu_torch.ops import shade as sh
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.utils.rng import TorchDraws

    gen = torch.Generator(dev).manual_seed(seed)
    pos = (torch.rand((p, 3), generator=gen, device=dev) - 0.5) * 0.8
    nrm = torch.nn.functional.normalize(torch.randn((p, 3), generator=gen, device=dev), dim=-1)
    view = torch.tensor([[0.0, 0.0, 2.5]], device=dev).expand(p, 3).contiguous()
    nrm = torch.where(((view - pos) * nrm).sum(-1, keepdim=True) < 0, -nrm, nrm)
    kd = torch.rand((p, 3), generator=gen, device=dev)
    ks = torch.stack([torch.zeros(p, device=dev), 0.1 + 0.9 * torch.rand(p, generator=gen, device=dev),
                      torch.rand(p, generator=gen, device=dev)], -1)
    mask = (torch.arange(p, device=dev) < int(MC_SHADE_FG_SHARE * p)).float()[:, None]
    light = update_pdf(torch.rand((512, 512, 3), generator=gen, device=dev) * 0.5 + 0.25)
    d = np.random.default_rng(seed).normal(size=(20_000, 3))
    shell = torch.tensor(0.45 * d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32, device=dev)
    occ, _ = sh.splat_lattice(shell, (-0.7,) * 3, (1.4,) * 3, res=65)
    vis = sh.make_shadow_field(occ, (-0.7,) * 3, (1.4,) * 3)
    got = {}
    apply = sh._MCShade.apply

    def grab(walk, m, *t):
        got.update(walk=walk, mask=m, tensors=t)
        return apply(walk, m, *t)

    sh._MCShade.apply = grab
    try:
        sh.env_shade(TorchDraws(torch.Generator(dev).manual_seed(seed)), mask, pos + nrm * 1e-3, pos, nrm, view, kd,
                     ks, light, n_samples_x=n, visibility=vis, shadow_scale=1.0, mc_block=block)
    finally:
        sh._MCShade.apply = apply
    return got["walk"], got["mask"], got["tensors"]


def mc_shade_bound_ms(p, n, live, cos_share, n_pool, light_texels, backward: bool):
    """(bound_ms, bound_by) of one walk: the least operations of the live
    rows (``MC_OPS``: each row's part once, each sample's by the share
    ``cos_share`` of samples that take the cosine lobe), or the bytes: every
    row's mask, the live rows' inputs and draws u (12 bytes a sample), the
    outputs, the pool and the light read once (the reverse: the live rows'
    cotangent g read and their input cotangents read and written, the pool's
    cotangent written once, the light's scratch read and written)."""
    ops = MC_OPS["bwd" if backward else "fwd"]
    per = [cos_share * c + (1.0 - cos_share) * g for c, g in zip(ops["cosine"], ops["ggx"])]
    instr = live * ops["row"][0] + live * n * n * per[0]
    mufu = live * ops["row"][1] + live * n * n * per[1]
    bytes_moved = 12 * live * n * n + 4 * p + 4 * 17 * live + 4 * 6 * p + 28 * n * n * n_pool + 8 * light_texels
    if backward:
        bytes_moved += 4 * 6 * live + 2 * 4 * 12 * live + 28 * n * n * n_pool + 2 * 16 * light_texels
    return _bound_ms(instr, bytes_moved, mufu)


def mc_shade_check(smi: str) -> dict:
    """The MC shade's kernel pair held against the eager walk at both
    reconstruction cells' shapes (a slice of the rows at 1024²) and timed:
    forward and reverse device ms, each against its bound; the eager walk
    and the kernel pair on the held rows, forward and reverse called from
    Python, timed after a first call."""
    import torch

    from gshell_tpu_torch.ops import shade as sh

    dev = torch.device("cuda:0")
    cells = []
    for i, (cell, p, n, block, held) in enumerate(MC_SHADE_CELLS):
        walk, mask, tensors = mc_shade_inputs(p, n, block, 100 + i, dev)
        live_rows = mask[:, 0] != 0
        live = int(live_rows.sum())
        cos_share = float((walk.u[:, live_rows, 2] < tensors[5][live_rows, 0]).float().mean())
        g = torch.randn((p, 6), generator=torch.Generator(dev).manual_seed(i), device=dev) * mask
        # held: the kernel against the eager walk on the first `held` rows
        sub = walk
        if held < p:
            sub = sh._ShadeWalk(walk.n, walk.block_size, walk.diffuse_only, walk.shadow_scale, walk.vis,
                                walk.ro[:held], walk.rot[:held], walk.u[:, :held].contiguous(), walk.c)
        rows_t = [t[:held] for t in tensors[:6]] + list(tensors[6:])

        def both_passes(fn):
            leaves = [t.detach().clone().requires_grad_(True) for t in rows_t]
            out = fn(*leaves) * mask[:held]
            return out.detach(), torch.autograd.grad(out, leaves, g[:held])

        plain = lambda *t: sh._MCAccumulate.apply(sub, *t)
        kernel = lambda *t: sh._MCShade.apply(sub, mask[:held], *t)
        (oe, ge), (ok, gk) = both_passes(plain), both_passes(kernel)
        walk_ms = [_sync_ms(lambda: both_passes(fn))[1] for fn in (plain, kernel)]  # warm: after the calls above
        if not all(bool(torch.isfinite(x).all()) for x in (oe, ok, *ge, *gk)):
            raise RuntimeError(f"mc shade at {cell}'s shape: a value or cotangent is not finite")
        errs = {"forward": _rel_norm(ok, oe)}
        for name, a, b in zip(sh._ShadeWalk.names, gk, ge):
            errs[name] = _rel_norm(a, b)
        worst = max(v / (2.0 ** -8 if k == "light_packed" else 1e-4) for k, v in errs.items())
        fwd_ms = _device_ms(lambda: sh.mc_walk_kernel(walk, mask, tensors), k=3)
        out, rows = sh.mc_walk_kernel(walk, mask, tensors)
        pool, light = tensors[6].contiguous(), tensors[7].contiguous()
        bwd_ms = _device_ms(lambda: sh.mc_rewalk_kernel(walk, rows, pool, light, g), k=2)
        n_pool, texels = pool.shape[1], light.shape[0] * light.shape[1]
        fb, fby = mc_shade_bound_ms(p, n, live, cos_share, n_pool, texels, False)
        bb, bby = mc_shade_bound_ms(p, n, live, cos_share, n_pool, texels, True)
        rec = {"cell": cell, "rows": p, "samples": n * n, "live_rows": live, "cosine_share": cos_share,
               "held_rows": held, "errors": errs, "err_of_room": worst, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
               "fwd_bound_ms": fb, "fwd_bound_by": fby, "bwd_bound_ms": bb, "bwd_bound_by": bby,
               "held_plain_ms": walk_ms[0], "held_kernel_ms": walk_ms[1]}
        cells.append(rec)
        print(f"mc shade at {cell}'s shape ({p} slots x {n * n} samples, {live} live, {cos_share:.3f} of the "
              f"samples on the cosine lobe, {held} held): forward {fwd_ms:.3f} ms, bound {fb:.3f} ms ({fby}, "
              f"{100 * fb / fwd_ms:.1f} %); reverse {bwd_ms:.3f} ms, bound {bb:.3f} ms ({bby}, "
              f"{100 * bb / bwd_ms:.1f} %); on the {held} held rows, forward and reverse called from Python after "
              f"a first call: eager walk {walk_ms[0]:.1f} ms, kernel {walk_ms[1]:.2f} ms; worst error "
              f"{worst:.3g} of its room "
              + "(" + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f")  [{smi}]")
        if worst > 1.0:
            raise RuntimeError(f"mc shade at {cell}'s shape: error {worst:.3g} of its room: {errs}")
        del walk, tensors, rows, out, ge, gk
        torch.cuda.empty_cache()
    return {"cells": cells, "card": smi}


def _median_ms(fn, n=10):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# Card vs CPU plain path on the small step: loss rtol and per group (cosine
# >=, relative norm difference <=), about 1.5x off the readings on an NVIDIA
# H100 80GB HBM3 at 700 W: loss 1.42e-4; deform .999559 / 8.7e-4, msdf 1.0 /
# 3.1e-8, sdf_net .996117 / 8.65e-2, tables .990065 / 9.3e-3, mlp .999975 /
# 8.2e-5, light .989952 / 1.42e-4.
SMALL_STEP_LOSS_RTOL = 2.5e-4
SMALL_STEP_LIMITS = {
    "deform": (0.9993, 1.5e-3), "msdf": (0.999999, 1e-6), "sdf_net": (0.994, 0.13),
    "tables": (0.985, 0.014), "mlp": (0.99996, 1.5e-4), "light": (0.985, 2.5e-4),
}


def _small_step_reference(dev) -> dict:
    """One train step of a small configuration on the card (both kernels)
    and on the CPU (their plain versions), from the same state and the same
    random draws.  The two devices sum the SDF MLP in another order, and a
    few Monte-Carlo samples flip on that round-off (as between the CPU path
    and the JAX package, tests/test_torch_slice.py), so the loss and each
    parameter group's gradient are held to limits set from the readings.
    Returns the readings."""
    import numpy as np
    import torch

    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.geometry.mlp import MLPConfig
    from gshell_tpu_torch.ops import math as gm
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max
    from gshell_tpu_torch.render.render import RenderFlags
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
    from gshell_tpu_torch.utils.rng import ReplayDraws, TorchDraws

    res = 64

    def source(kind, name, shape, lo, hi):  # the same draws on both devices
        rng = np.random.default_rng(sum(ord(c) * 31 ** i for i, c in enumerate(name)) % 2**32)
        if kind == "uniform":
            return rng.uniform(lo, hi, size=shape).astype(np.float32)
        if kind == "normal":
            return rng.normal(size=shape).astype(np.float32)
        return rng.integers(lo, hi, size=shape)

    def reconstructor(d):
        geo = GShellGeometry(GeometryConfig(grid_res=16, n_eikonal_samples=512, mlp=MLPConfig(
            n_freq=4, d_hidden=64, n_hidden=2, skip_in=(1,))), d)
        mat = MLPTexture3DConfig(hash=HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                                                     desired_resolution=64),
                                 internal_dims=16, min_max=default_kd_ks_min_max())
        flags = RenderFlags(resolution=(res, res), n_samples=2, shade_budget=0.5, mc_block=2,
                            light_bf16=True)
        return Reconstructor(geo, mat, flags, TrainConfig(batch=1))

    rec_cpu, rec_gpu = reconstructor("cpu"), reconstructor(dev)
    init = rec_cpu.init_state(TorchDraws(torch.Generator().manual_seed(1)), pretrain_steps=300)
    mvp = gm.perspective(math.radians(45.0)) @ gm.lookat([0.0, 0.0, 2.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    ys, xs = torch.meshgrid(torch.arange(res), torch.arange(res), indexing="ij")
    disk = ((xs - res / 2) ** 2 + (ys - res / 2) ** 2 < (0.3 * res) ** 2).float()[None, ..., None]
    target = {"mvp": mvp[None], "campos": torch.tensor([[0.0, 0.0, 2.5]]),
              "img": torch.cat([0.5 * disk.repeat(1, 1, 1, 3), disk], -1),
              "background": torch.zeros((1, res, res, 3))}
    out = {}
    for rec, d in ((rec_cpu, "cpu"), (rec_gpu, dev)):
        state = rec.make_state(init.params_geo, init.params_mat, init.light_base, step=1000)
        m = rec.train_step(state, ReplayDraws(source, device=d), {k: v.to(d) for k, v in target.items()})
        grads = {
            "deform": state.params_geo["deform"].grad, "msdf": state.params_geo["msdf"].grad,
            "sdf_net": torch.cat([p.grad.reshape(-1) for v in state.params_geo["sdf_net"].values() for p in v]),
            "tables": state.params_mat["tables"].grad,
            "mlp": torch.cat([w.grad.reshape(-1) for w in state.params_mat["mlp"]]),
            "light": state.light_base.grad,
        }
        out[str(d)] = (float(m["total"]), {k: g.detach().double().cpu().reshape(-1) for k, g in grads.items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(dev)]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    read = {}
    for k in g_cpu:
        a, b = g_gpu[k], g_cpu[k]
        na, nb = float(a.norm()), float(b.norm())
        read[k] = (float(a @ b) / max(na * nb, 1e-300), abs(na - nb) / max(nb, 1e-300))
    print(f"small step, card vs CPU plain path: total {l_gpu:.7f} vs {l_cpu:.7f} (rel {rel:.2e}); "
          "gradient cosine / rel. norm diff " + ", ".join(f"{k} {c:.6f} / {dn:.2e}" for k, (c, dn) in read.items()))
    bad = [k for k, (c, dn) in read.items() if c < SMALL_STEP_LIMITS[k][0] or dn > SMALL_STEP_LIMITS[k][1]]
    if not math.isfinite(l_gpu) or rel > SMALL_STEP_LOSS_RTOL or bad:
        raise RuntimeError(f"the train step on the card disagrees with the CPU plain path ({bad or 'loss'})")
    return {"loss_rel": rel, **read}


def working_point(dev, seed: int = SEED):
    """The slice at the working point, on ``dev``: ``Reconstructor`` with the
    settings of the port's bench (``gshell_tpu_torch.bench``, the JAX
    package's bench.py values), its state after 1000 SDF pretrain steps
    set to step ``shadow_ramp_iters`` (shadows and denoiser sigma 2 live),
    the draw source, and the bench's synthetic disk target at batch BATCH."""
    import torch

    from gshell_tpu_torch import bench

    t0 = time.time()
    rec, state, draws, target = bench.build(False, RES, GRID, SPP, BATCH, dev, seed)
    torch.cuda.synchronize()
    print(f"init_state (1000 pretrain steps): {time.time() - t0:.2f} s")
    state.step = rec.tcfg.shadow_ramp_iters
    return rec, state, draws, target


def probe_view(rec, state, draws, target, mesh, faces_c, v_nrm) -> dict:
    """The first view rendered without the denoiser: its normals and (z, dz)
    guide the denoiser check.  It takes its draws from ``draws`` before the
    train steps do."""
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.render.render import render_mesh

    return render_mesh(draws.child("probe"), mesh.verts, faces_c, v_nrm, mesh.msdf,
                       state.params_mat, rec.mat_cfg, target["mvp"][0], target["campos"][0],
                       update_pdf(state.light_base), rec.flags._replace(use_denoiser=False))


def _finite(x) -> bool:
    return x is not None and math.isfinite(float(x))


def hold_stage_b(label, args, out=None) -> float:
    """Stage B's kernel output (``out``, or a launch on ``args``) against
    the plain version on the same pairs: ids identical on every pixel, z
    identical where hit.  Returns max |z err| over the hit pixels."""
    import torch

    from gshell_tpu_torch.ops import rasterize as rz

    kz, kid = out if out is not None else rz.rasterize_stage_b(*args)
    pz, pid = rz.stage_b_plain(*args)
    n_diff = int((kid != pid).sum())
    hit = pid >= 0
    z_diff = int((kz[hit] != pz[hit]).sum())
    cnt = args[2].float()
    n_subs = rz.stage_b_schedule(args[1], args[2]).shape[0]
    print(f"stage B {label}: {int(cnt.sum())} pairs, pairs per tile max {int(cnt.max())} mean "
          f"{float(cnt.mean()):.2f} p99 {float(torch.quantile(cnt, 0.99)):.1f}, {n_subs} sub-segments; "
          f"{int(hit.sum())} px hit, {n_diff} ids differ, {z_diff} hit z differ")
    if n_diff or z_diff:
        raise RuntimeError(f"stage-B kernel disagrees with the plain version ({label})")
    return float((kz[hit] - pz[hit]).abs().max()) if hit.any() else 0.0


def hold_bilateral(label, args, out) -> float:
    """The stencil's kernel output ``out`` against the plain version on the
    same ``args`` (col, nrm, zdz, sigma, r, denom_from_tap), rtol 1e-5 /
    atol 1e-6.  Returns max |err|."""
    from gshell_tpu_torch.ops import denoiser as dn

    errs = []
    for k, p in zip(out, dn.bilateral_plain(*args)):
        err = (k - p).abs()
        bad = int((err > 1e-6 + 1e-5 * p.abs()).sum())
        errs.append(float(err.max()))
        print(f"denoiser {label} C={args[0].shape[-1]} denom_from_tap={args[5]}: "
              f"max |err| {errs[-1]:.3e}, {bad} outside rtol 1e-5 / atol 1e-6")
        if bad:
            raise RuntimeError(f"bilateral kernel disagrees with the plain version ({label})")
    return max(errs)


# Rows of a tapped MC shade launch held against the eager walk: a window
# from the first live row (the eager walk at 1024² x 576 samples takes
# seconds a view on all of them).
MC_TAP_ROWS = 8192
# The tapped MC shade launches against the eager walk on their window: the
# forward's and each per-row input's cotangent's relative norm error.  Ten
# times the card tests' 1e-4: a path's roughness reaches min_roughness
# 0.08, where an ulp moves a sharp specular sample by percents (the card
# tests draw roughness from 0.1).
MC_TAP_RTOL = 1e-3
# The kernels whose first and last launches every path holds.
KERNELS_HELD = {"rasterize_stage_b", "bilateral_accumulate", "mc_shade"}


def zero_launches() -> None:
    """Every hand kernel's launch counter (``kernel_launches()``) to 0."""
    from gshell_tpu_torch.ops import denoiser as dn
    from gshell_tpu_torch.ops import gather as ga
    from gshell_tpu_torch.ops import rasterize as rz
    from gshell_tpu_torch.ops import shade as sh

    rz.stage_b_calls = dn.bilateral_launches = ga.gather_bwd_launches = sh.mc_shade_launches = 0


def _mc_window(walk, live):
    """(start, the walk of rows [start, start + MC_TAP_ROWS)): from the first
    row of ``live``; the pool's rotation reads the row index, so the
    window's rotation is shifted by its start."""
    from gshell_tpu_torch.ops import shade as sh

    nz = live.nonzero()
    a = int(nz[0, 0]) if nz.numel() else 0
    b = min(a + MC_TAP_ROWS, live.shape[0])
    sub = sh._ShadeWalk(walk.n, walk.block_size, walk.diffuse_only, walk.shadow_scale, walk.vis,
                        walk.ro[a:b].clone(), walk.rot[a:b].clone(), walk.u[:, a:b].clone(), walk.c + a)
    return a, sub


def _tap_mc_walk(walk, mask, tensors, out):
    """A forward launch: its window's inputs and output."""
    a, sub = _mc_window(walk, mask[:, 0] != 0)
    b = a + sub.ro.shape[0]
    rows = [t[a:b].detach().clone() for t in tensors[:6]] + [t.detach().clone() for t in tensors[6:]]
    return (sub, mask[a:b].clone(), rows), out[0][a:b].clone()


def _tap_mc_rewalk(walk, rows, pool, light, g, need=(True,) * 8, out=()):
    """A reverse launch: its window's packed rows, cotangent and per-row
    input cotangents (the pool's and the light's sum over every row, so they
    are not held here: the card tests hold them)."""
    a, sub = _mc_window(walk, (rows[:, 17] != 0) & (g != 0).any(dim=1))
    b = a + sub.ro.shape[0]
    kept = tuple(None if x is None else x[a:b].clone() for x in out[:6])
    return (sub, rows[a:b].clone(), pool.clone(), light.clone(), g[a:b].clone(), tuple(need)), kept


def hold_mc_walk(label, args, out) -> float:
    """A tapped forward launch against the eager walk on its window.
    Returns the relative norm error."""
    import torch

    from gshell_tpu_torch.ops import shade as sh

    walk, mask, tensors = args
    want = sh._MCAccumulate.apply(walk, *tensors) * mask
    err = _rel_norm(out, want)
    live = int((mask != 0).sum())
    print(f"mc shade {label}: {walk.ro.shape[0]} rows ({live} live) x {walk.n2} samples, forward relative "
          f"error {err:.2e}")
    if not bool(torch.isfinite(out).all()) or not err <= MC_TAP_RTOL:
        raise RuntimeError(f"mc shade kernel disagrees with the eager walk ({label}): {err}")
    return err


def hold_mc_rewalk(label, args, out) -> float:
    """A tapped reverse launch's per-row input cotangents against the eager
    walk's on its window.  Returns the largest relative norm error."""
    import torch

    from gshell_tpu_torch.ops import shade as sh

    walk, rows, pool, light, g, need = args
    zeros = torch.zeros_like(rows[:, 0:2])
    leaves = [rows[:, 0:3], rows[:, 3:6], torch.cat([zeros, rows[:, 6:7]], 1), rows[:, 7:10], rows[:, 10:11],
              rows[:, 11:12]]
    leaves = [x.clone().requires_grad_(nd) for x, nd in zip(leaves, need)]
    with torch.enable_grad():
        acc = sh._MCAccumulate.apply(walk, *leaves, pool, light)
        asked = [x for x, nd in zip(leaves, need) if nd]
        got = iter(torch.autograd.grad(acc, asked, g, allow_unused=True) if asked else ())
    errs = {}
    for name, x, nd, k in zip(sh._ShadeWalk.names, leaves, need, out):
        if not nd:
            continue
        e = next(got)
        e = torch.zeros_like(x) if e is None else e
        if not bool(torch.isfinite(k).all()) or not bool(torch.isfinite(e).all()):
            raise RuntimeError(f"mc shade reverse ({label}): a cotangent of {name} is not finite")
        errs[name] = _rel_norm(k, e)
    worst = max(errs.values(), default=0.0)
    print(f"mc shade reverse {label}: {walk.ro.shape[0]} rows x {walk.n2} samples, relative error "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not worst <= MC_TAP_RTOL:
        raise RuntimeError(f"mc shade reverse kernel disagrees with the eager walk ({label}): {errs}")
    return worst


def _rel_norm(a, b) -> float:
    import torch

    d = torch.linalg.vector_norm((a.float() - b.float()).double())
    return float(d / torch.linalg.vector_norm(b.float().double()).clamp(min=1e-30))


class KernelTaps:
    """While installed, the kernel wrappers keep a copy of the inputs and
    the outputs of their first and their last launch since the last
    ``clear()``, so that what a path fed the kernels can be held against
    the plain versions after its launch counts are read (the MC shade's:
    a window of rows, :func:`_mc_window`).  The wrappers count their
    launches as before."""

    def __init__(self):
        from gshell_tpu_torch.ops import denoiser as dn
        from gshell_tpu_torch.ops import rasterize as rz
        from gshell_tpu_torch.ops import shade as sh

        self.slots = {"rasterize_stage_b": (rz, "rasterize_stage_b", self._stage_b_args),
                      "bilateral_accumulate": (dn, "bilateral_accumulate", self._bilateral_args),
                      "mc_shade": (sh, "mc_walk_kernel", _tap_mc_walk),
                      "mc_shade_reverse": (sh, "mc_rewalk_kernel", _tap_mc_rewalk)}
        self.fns = {name: getattr(mod, attr) for name, (mod, attr, _) in self.slots.items()}
        self.taps = {}

    @staticmethod
    def _stage_b_args(pair_data, tile_start, tile_cnt, n_tiles, tx_n, out=()):
        keep = lambda x: x.detach().clone() if hasattr(x, "detach") else x
        return tuple(map(keep, (pair_data, tile_start, tile_cnt, n_tiles, tx_n))), tuple(map(keep, out))

    @staticmethod
    def _bilateral_args(col, nrm, zdz, sigma, r=11, denom_from_tap=False, out=()):
        keep = lambda x: x.detach().clone() if hasattr(x, "detach") else x
        return tuple(map(keep, (col, nrm, zdz, sigma, r, denom_from_tap))), tuple(map(keep, out))

    def clear(self):
        self.taps = {name: [] for name in self.slots}

    def __enter__(self):
        import torch

        for name, (mod, attr, take) in self.slots.items():
            def tapped(*args, _fn=self.fns[name], _name=name, _take=take, **kw):
                out = _fn(*args, **kw)
                with torch.no_grad():
                    tap = _take(*args, **kw, out=out)
                seen = self.taps[_name]
                if seen:
                    seen[1:] = [tap]
                else:
                    seen.append(tap)
                return out
            setattr(mod, attr, tapped)
        self.clear()
        return self

    def __exit__(self, *exc):
        for name, (mod, attr, _) in self.slots.items():
            setattr(mod, attr, self.fns[name])


def hold_taps(label, taps, held) -> None:
    """Each kernel's first and last tapped launch against its plain version;
    the largest error per kernel into ``held`` (the MC shade's forward and
    reverse under "mc_shade")."""
    import torch

    hold = {"rasterize_stage_b": hold_stage_b, "bilateral_accumulate": hold_bilateral, "mc_shade": hold_mc_walk,
            "mc_shade_reverse": hold_mc_rewalk}
    with torch.no_grad():
        for name, fn in hold.items():
            key = "mc_shade" if name == "mc_shade_reverse" else name
            for when, (args, out) in zip(("first", "last"), taps.get(name, [])):
                held[key] = max(held.get(key, 0.0), fn(f"{label}, {when} launch", args, out))


class EntryPoints:
    """Runs the port's entry points with the launch counts set to 0 just
    before each call and read just after it (the entry points report each
    of their phases, which must sum to the counts; no MC shade walk may be
    eager), with ``KernelTaps`` installed; then holds each kernel's first
    and last launch of the call against its plain version, and keeps the
    largest error per kernel in ``held``."""

    def __init__(self, taps: KernelTaps):
        self.taps, self.held = taps, {}

    def counted(self, fn, argv):
        import torch

        from gshell_tpu_torch.ops import shade as sh
        from gshell_tpu_torch.train.setup import kernel_launches

        self.taps.clear()
        zero_launches()
        eager = sh.shade_stats()["eager_walks"]
        t0 = time.time()
        out = fn(argv)
        torch.cuda.synchronize()
        out["seconds"] = time.time() - t0
        for k, v in kernel_launches().items():
            if sum(p[k] for p in out["launches"].values()) != v:
                raise RuntimeError(f"{fn.__module__}: {k} launches by phase {out['launches']} do not sum to {v}")
        if sh.shade_stats()["eager_walks"] != eager:
            raise RuntimeError(f"{fn.__module__}: the MC shade took the eager walk on the card")
        out["taps"] = self.taps.taps
        return out

    def hold(self, label, run_out):
        hold_taps(label, run_out.pop("taps"), self.held)

    def train(self, argv, label):
        import torch

        from gshell_tpu_torch import train_gshell

        torch.cuda.reset_peak_memory_stats()
        out = self.counted(train_gshell.main, argv)
        out["peak"] = torch.cuda.max_memory_allocated() / 2**30  # before the plain versions run
        self.hold(label, out)
        return out

    def evaluate(self, argv, label):
        from gshell_tpu_torch import eval_reconstruction

        out = self.counted(eval_reconstruction.main, argv)
        self.hold(label, out)
        return out


def cli_path(smi: str):
    """Phase 7: generator → ``train_gshell.main`` (2 iterations, then resumed
    to 4) → ``eval_reconstruction.main`` at the skirt config's full width.
    The launch counts are set to 0 before each entry point and read after
    it; the entry points report each of their phases.  Then each kernel's
    first and last launch of each entry point (a ground-truth view, a train
    step's last view backward, an eval view) is held against its plain
    version on the inputs that path gave it.  Returns (the launches per
    path, max |err| per kernel); raises on any failed check."""
    import shutil

    from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj

    shutil.rmtree(CLI_OUT, ignore_errors=True)
    os.makedirs(CLI_OUT)
    obj = os.path.join(CLI_OUT, "skirt.obj")
    write_obj(obj, *skirt())
    with open(CLI_CONFIG) as f:
        cfg = json.load(f)
    cfg["save_interval"] = 2
    cfg_path = os.path.join(CLI_OUT, "skirt_smoke.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    run = os.path.join(CLI_OUT, "run")
    common = ["--config", cfg_path, "--ref-mesh", obj, "--out-dir", run, "--log-interval", "1"]

    with KernelTaps() as taps:
        ep = EntryPoints(taps)
        first = ep.train(common + ["--iter", "2"], "cli train (ground truth, then train step 1)")
        resumed = ep.train(common + ["--iter", "4", "--resume"], "cli resumed train (ground truth, then train step 3)")
        ev = ep.evaluate([
            "--state", os.path.join(run, "state.pt"), "--config", cfg_path, "--synthetic-ref-mesh", obj,
            "--gt-mesh", obj, "--gt-unit-size", "--n-views", "16", "--out-dir", os.path.join(run, "validate")],
            "cli eval (held-out ground truth, then eval view 15)")
    held = ep.held
    if set(held) != KERNELS_HELD:
        raise RuntimeError(f"phase 7 held only {sorted(held)} against the plain versions")

    log = first["log"] + resumed["log"]
    for e in log:
        print(f"cli step {e['it']}: total {e['total']:.6f} img {e['img_loss']:.6f} reg {e['reg_loss']:.6f} "
              f"n_valid_tets {int(e['n_valid_tets'])} n_faces {int(e['n_faces'])} "
              f"raster_dropped {int(e['raster_dropped'])} px_dropped {int(e['px_dropped'])} "
              f"splat cells {int(e['splat_cells'])}, {e['splat_samples_per_cell']:.2f} samples/cell, "
              f"{int(e['splat_singletons'])} singletons | {e['s']:.3f} s/step  [{smi}]")
    steady = sorted(e["s"] for e in log[1:])
    with open(os.path.join(run, "mesh_000004.obj")) as f:
        obj_faces = sum(1 for line in f if line.startswith("f "))
    gt = first["gt_splat"]
    print(f"cli ground truth: {first['gt_views']} views at {RES}² in {first['gt_seconds']:.2f} s "
          f"({first['gt_seconds'] / first['gt_views']:.4f} s/view, mesh load and shadow field included); "
          f"resumed run {resumed['gt_seconds'] / resumed['gt_views']:.4f} s/view; GT splat cells "
          f"{int(gt['splat_cells'])}, {gt['splat_samples_per_cell']:.2f} samples/cell, "
          f"{int(gt['splat_singletons'])} singletons  [{smi}]")
    print(f"cli train at grid 96: steps {[round(e['s'], 3) for e in log]} s, median after the first "
          f"{steady[len(steady) // 2]:.3f} s/step; peak memory {max(first['peak'], resumed['peak']):.2f} GiB "
          f"(each train run, ground truth and SDF pretrain included); resumed at iter {resumed['start_it']}; "
          f"final OBJ {obj_faces} faces  [{smi}]")
    print(f"cli eval: {ev['seconds']:.2f} s for 16 held-out views + Chamfer; PSNR {ev.get('psnr')} dB, "
          f"MSE {ev.get('mse')}, Chamfer-L2 {ev.get('chamfer')}  [{smi}]")
    launches = {"gt_train": first["launches"]["dataset"], "gt_resumed": resumed["launches"]["dataset"],
                "train": first["launches"]["train"], "train_resumed": resumed["launches"]["train"],
                "gt_eval": ev["launches"]["ground_truth"], "eval": ev["launches"]["synthetic"]}
    print(f"cli launches by path: {json.dumps(launches)}")

    bad = [f"step {e['it']} {k}" for e in log for k in ("total", "img_loss", "reg_loss") if not _finite(e[k])]
    bad += [f"step {e['it']}: n_faces {e['n_faces']}, raster_dropped {e['raster_dropped']}"
            for e in log if e["n_faces"] <= 0 or e["raster_dropped"] != 0]
    if resumed["start_it"] != 2 or [e["it"] for e in resumed["log"]] != [2, 3]:
        bad.append(f"resumed run started at {resumed['start_it']} ({[e['it'] for e in resumed['log']]})")
    if obj_faces <= 0 or resumed["final_faces"] <= 0:
        bad.append(f"final OBJ has {obj_faces} faces")
    if not (_finite(ev.get("psnr")) and _finite(ev.get("chamfer"))):
        bad.append(f"eval PSNR {ev.get('psnr')}, Chamfer {ev.get('chamfer')}")
    bad += unlaunched(launches)
    if bad:
        raise RuntimeError("phase 7 (command-line path) failed: " + "; ".join(bad))
    return launches, held


# Phase 8: G-MeshDiffusion at the full width of configs/diffusion_upper_occgrid.json
# (the UNet3DConfig defaults): tet resolution 64, grids 128³×4 and 256³.
DIFF_RES = 64
DIFF_SHAPES = 4
DIFF_OUT = os.path.join(ROOT, "out", "chip_smoke", "diffusion")  # gitignored
# The JAX package's parameter count at the default config
# (tests/test_torch_unet3d.py holds both packages to it).
UNET_PARAMS = 411_065_605
DIFF_CUTS = ["batch 1 x grad-acc 2 per step in place of 8 x 4 (one card, not eight)",
             "3 iterations, then 1 resumed, in place of 2.4M",
             "10 DDIM steps and 1 sample in place of 100 and 8",
             "4 synthetic open ellipsoids (direct SDF + tilted mSDF plane) in place of baked DeepFashion"]
# Card vs CPU at a small width (UNet3D base 16, ch_mult (1, 2), grid 16, TF32
# off, deterministic cuDNN): the outputs' and the loss's max |err| / max
# |value| and, per parameter group, (gradient cosine >=, relative norm
# difference <=), about 1.5x off the readings (H100 80GB HBM3, 700 W; three
# runs read alike): outputs 3.07e-6 (grid) / 1.11e-6 (occupancy), loss 0;
# 1 - cosine 6.7e-13 / 2.21e-12 / 2.16e-12 / 1.78e-12 / 5.5e-13 and relative
# norm difference 3.14e-8 / 3.60e-8 / 2.06e-8 / 3.07e-8 / 7.06e-9 for stem /
# down / mid / up / head.
DIFF_SMALL_OUT_RTOL = 5e-6
DIFF_SMALL_LIMITS = {"stem": (1 - 1e-12, 5e-8), "down": (1 - 3.5e-12, 5.5e-8), "mid": (1 - 3.5e-12, 3.1e-8),
                     "up": (1 - 2.7e-12, 4.6e-8), "head": (1 - 8.5e-13, 1.1e-8)}


def _diffusion_small_reference(dev) -> dict:
    """A forward and the loss's backward of a small UNet3D on the card and on
    the CPU, with the same weights, inputs, masks and loss draws, IEEE
    float32 on both.  Returns the readings, with the groups outside their
    limits under ``"outside_limits"``."""
    import numpy as np
    import torch

    from gshell_tpu_torch.models.losses import ddpm_loss
    from gshell_tpu_torch.models.sde import make_vpsde
    from gshell_tpu_torch.models.unet3d import UNet3D, UNet3DConfig, compute_policy, init_unet
    from gshell_tpu_torch.utils.rng import ReplayDraws, TorchDraws

    cfg = UNet3DConfig(base_channels=16, ch_mult=(1, 2), down_block_types=("ResBlock", "AttnResBlock"),
                       up_block_types=("AttnResBlock", "ResBlock"), dropout=0.0)
    d, rng = 16, np.random.default_rng(3)
    model = init_unet(UNet3D(cfg), TorchDraws(torch.Generator().manual_seed(3)))
    with torch.no_grad():  # lift the near-zero output convolutions so every group carries gradient
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0.0, 0.02, size=tuple(p.shape)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(2, 4, d, d, d)).astype(np.float32))
    occ = torch.from_numpy(rng.normal(size=(2, 1, 2 * d, 2 * d, 2 * d)).astype(np.float32))
    fm = torch.from_numpy((rng.uniform(size=(1, 4, d, d, d)) > 0.3).astype(np.float32))
    om = torch.from_numpy((rng.uniform(size=(1, 1, 2 * d, 2 * d, 2 * d)) > 0.3).astype(np.float32))
    t = torch.tensor([17, 640])

    def source(kind, name, shape, lo, hi):
        r = np.random.default_rng(sum(ord(c) * 31 ** i for i, c in enumerate(name)) % 2**32)
        return r.integers(lo, hi, size=shape) if kind == "randint" else r.normal(size=shape).astype(np.float32)

    runs, cudnn_det = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same cuDNN algorithms, so the same readings, in every run
    for where in ("cpu", dev):
        m = UNet3D(cfg).to(where)
        m.load_state_dict(model.state_dict())
        to = lambda a: a.to(where)
        with compute_policy("float32", torch.device(where).type):
            with torch.no_grad():
                g, o = m(to(x), to(occ), to(t), to(fm), None, to(om))
            loss = ddpm_loss(make_vpsde(device=where), m, ReplayDraws(source, device=where),
                             {"grid": to(x), "occgrid": to(occ)}, to(fm), to(om))
            loss.backward()
        grads = {}
        for name, p in m.named_parameters():
            grads.setdefault(m.param_group(name), []).append(p.grad.detach().double().cpu().reshape(-1))
        runs[str(where)] = (g.double().cpu(), o.double().cpu(), float(loss.detach()),
                            {k: torch.cat(v) for k, v in grads.items()})
    torch.backends.cudnn.deterministic = cudnn_det
    (g_c, o_c, l_c, gr_c), (g_d, o_d, l_d, gr_d) = runs["cpu"], runs[str(dev)]
    read = {"grid": float((g_d - g_c).abs().max() / g_c.abs().max()),
            "occ": float((o_d - o_c).abs().max() / o_c.abs().max()),
            "loss": abs(l_d - l_c) / abs(l_c)}
    for k in gr_c:
        a, b = gr_d[k], gr_c[k]
        na, nb = float(a.norm()), float(b.norm())
        read[k] = (float(a @ b) / max(na * nb, 1e-300), abs(na - nb) / max(nb, 1e-300))
    print("diffusion small UNet3D, card vs CPU (IEEE f32): output max rel err grid "
          f"{read['grid']:.2e} occ {read['occ']:.2e}, loss rel {read['loss']:.2e}; gradient 1 - cosine / rel. "
          "norm diff " + ", ".join(f"{k} {1 - read[k][0]:.2e} / {read[k][1]:.2e}" for k in DIFF_SMALL_LIMITS))
    bad = [k for k in ("grid", "occ", "loss") if not read[k] <= DIFF_SMALL_OUT_RTOL]
    bad += [k for k, (c, dn) in DIFF_SMALL_LIMITS.items() if not (read[k][0] >= c and read[k][1] <= dn)]
    read["outside_limits"] = bad
    return read


def diffusion_path(smi: str, dev) -> dict:
    """Phase 8: the diffusion path through the port's entry points at full
    width — synthetic shapes → ``bake_grids.main`` (and the round trip
    ``decode(bake(·))`` against the extractor) → a small UNet3D card vs CPU →
    ``main_diffusion.main`` trains 3 iterations with a snapshot, then resumes
    for 1 → a 10-step DDIM sample with the EMA weights →
    ``eval_gmeshdiffusion.main`` decodes the sample and a baked grid.
    Returns the phase's record; raises on any failed check."""
    import glob
    import shutil

    import numpy as np
    import torch

    from gshell_tpu_torch import bake_grids, eval_gmeshdiffusion, main_diffusion
    from gshell_tpu_torch.geometry.generative_decode import GenerativeCodec
    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.models.sampling import ddim_timesteps
    from gshell_tpu_torch.models.unet3d import UNet3DConfig, forward_flops
    from gshell_tpu_torch.utils.synthetic import open_ellipsoid_state

    t_phase = time.time()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    shutil.rmtree(DIFF_OUT, ignore_errors=True)
    states, baked_dir, wd = (os.path.join(DIFF_OUT, n) for n in ("states", "baked", "run"))
    shapes = []
    for i in range(DIFF_SHAPES):
        os.makedirs(os.path.join(states, f"shape{i}"))
        shapes.append(open_ellipsoid_state(DIFF_RES, seed=i))
        torch.save(shapes[-1], os.path.join(states, f"shape{i}", "state.pt"))
    rec = {"cuts": DIFF_CUTS}

    # ---- bake, and the round trip on the card ----
    t0 = time.time()
    baked = bake_grids.main(["--states", os.path.join(states, "*", "state.pt"), "--grid-res", str(DIFF_RES),
                             "--out-dir", baked_dir, "--device", str(dev)])
    sync()
    rec["bake_seconds"] = time.time() - t0
    fm = om = None
    for path in baked.values():
        with np.load(path) as z:
            if z["grid"].shape != (2 * DIFF_RES,) * 3 + (4,) or z["occgrid"].shape != (4 * DIFF_RES,) * 3:
                raise RuntimeError(f"{path}: grid {z['grid'].shape}, occgrid {z['occgrid'].shape}")
            fm = z["feature_mask"] if fm is None else np.maximum(fm, z["feature_mask"])
            om = z["occ_mask"] if om is None else np.maximum(om, z["occ_mask"])
    mask_file = os.path.join(DIFF_OUT, "masks.npz")
    np.savez(mask_file, feature_mask=fm, occ_mask=om)
    geo = GShellGeometry(GeometryConfig(grid_res=DIFF_RES, use_sdf_mlp=False), dev)
    codec = GenerativeCodec(geo.extractor)
    rec["roundtrip"] = []
    for i, st in enumerate(shapes):
        params = {k: v.to(dev) for k, v in st["params_geo"].items()}
        v_def, sdf, msdf = geo.fields(params)
        with torch.no_grad():
            direct = geo.extractor(v_def, sdf, msdf)
        dec = codec.decode(v_def, codec.bake(v_def, sdf, msdf, params["deform"]))
        fv = direct.face_valid
        same_faces = bool(torch.equal(fv, dec.face_valid)) and bool(torch.equal(direct.faces[fv], dec.faces[fv]))
        used = torch.unique(direct.faces[fv])
        err = float((direct.verts[used] - dec.verts[used]).abs().max()) if used.numel() else 0.0
        rec["roundtrip"].append({"faces": int(fv.sum()), "same_faces": same_faces, "max_vert_err": err})
        if not same_faces or err > 2e-2 or int(fv.sum()) == 0:
            raise RuntimeError(f"round trip of shape {i}: {rec['roundtrip'][-1]}")
    print(f"diffusion bake: {DIFF_SHAPES} shapes at tet res {DIFF_RES} in {rec['bake_seconds']:.2f} s; "
          f"masks {int(fm[..., 0].sum())} / {int(om.sum())} sites; round trip faces "
          f"{[r['faces'] for r in rec['roundtrip']]}, equal faces, max vertex error "
          f"{max(r['max_vert_err'] for r in rec['roundtrip']):.3e}  [{smi}]")
    del geo, codec, direct, dec, params, v_def, sdf, msdf

    # ---- card vs CPU at a small width ----
    rec["card_vs_cpu"] = _diffusion_small_reference(dev)

    # ---- train at full width, then resume ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = ["--mode", "train", "--data-glob", os.path.join(baked_dir, "*.npz"), "--mask-file", mask_file,
             "--workdir", wd, "--batch", "1", "--grad-acc", "2", "--snapshot-freq", "2", "--log-freq", "1",
             "--device", str(dev)]
    first = main_diffusion.main(train + ["--n-iters", "3"])
    resumed = main_diffusion.main(train + ["--n-iters", "4"])
    sync()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log = first["log"] + resumed["log"]
    steady = sorted(e["s"] for e in log[1:])
    s_step = steady[len(steady) // 2]
    samples_per_step = 1 * 2
    flops = 3 * forward_flops(UNet3DConfig(), 2 * DIFF_RES)
    rec["train"] = {
        "params": first["params"], "precision": "float32 (IEEE, TF32 off)", "remat": False,
        "steps_s": [e["s"] for e in log], "loss": [e["loss"] for e in log],
        "s_per_step": s_step, "s_per_micro_step": s_step / samples_per_step, "peak_gib": peak,
        "snapshot_bytes": first["snapshot_bytes"], "snapshot_seconds": first["snapshot_seconds"],
        "flops_per_sample": flops, "tflops": flops * samples_per_step / s_step / 1e12,
        "saved_step": 3, "resumed_at": resumed["start_step"],
        "resumed_log_steps": [e["step"] for e in resumed["log"]],
    }
    tr = rec["train"]
    print(f"diffusion train at 128³/256³: {tr['params']} parameters (JAX {UNET_PARAMS}), {tr['precision']}, "
          f"remat off; steps {[round(s, 3) for s in tr['steps_s']]} s, median after the first "
          f"{s_step:.3f} s/step ({tr['s_per_micro_step']:.3f} s per micro-step), losses "
          f"{[round(v, 5) for v in tr['loss']]}; peak {peak:.2f} GiB; snapshot {tr['snapshot_bytes']} bytes in "
          f"{tr['snapshot_seconds']:.2f} s; resumed at step {tr['resumed_at']}; {flops / 1e12:.1f} TFLOP per "
          f"trained sample (3 x forward), {tr['tflops']:.2f} TFLOP/s  [{smi}]")

    # ---- sample, then decode ----
    n_ddim = 10
    gen = main_diffusion.main(["--mode", "uncond_gen", "--sampling-method", "ddim", "--n-sampling-steps",
                               str(n_ddim), "--n-samples", "1", "--mask-file", mask_file, "--workdir", wd,
                               "--device", str(dev)])
    n_steps = len(ddim_timesteps(1000, n_ddim))
    rec["sample"] = {"ddim_steps": n_steps, "seconds": gen["seconds"], "sampling_seconds": gen["sampling_seconds"],
                     "s_per_step": gen["sampling_seconds"] / n_steps, "from_step": gen["start_step"]}
    with np.load(gen["samples"][0]) as z:
        finite = bool(np.isfinite(z["grid"]).all() and np.isfinite(z["occgrid"]).all())
        rec["sample"]["shapes"] = [list(z["grid"].shape), list(z["occgrid"].shape)]
    with np.load(baked["shape0"]) as z:
        np.savez_compressed(os.path.join(wd, "baked_shape0.npz"), grid=z["grid"], occgrid=z["occgrid"])
    meshes = os.path.join(DIFF_OUT, "meshes")
    faces = eval_gmeshdiffusion.main(["--samples", os.path.join(wd, "*.npz"), "--grid-res", str(DIFF_RES),
                                      "--out-dir", meshes, "--device", str(dev)])
    rec["decode"] = {"sample_faces": faces["sample_0000"], "baked_faces": faces["baked_shape0"],
                     "roundtrip_faces": rec["roundtrip"][0]["faces"],
                     "objs": sorted(os.path.basename(p) for p in glob.glob(os.path.join(meshes, "*.obj")))}
    print(f"diffusion sample: {n_steps} DDIM steps in {gen['sampling_seconds']:.2f} s "
          f"({rec['sample']['s_per_step']:.3f} s/step; {gen['seconds']:.2f} s with the .npz) with the EMA weights "
          f"of step {gen['start_step']}; decoded sample {faces['sample_0000']} faces, baked shape 0 "
          f"{faces['baked_shape0']} faces (round trip {rec['roundtrip'][0]['faces']})  [{smi}]")

    bad = [f"step {e['step']} loss {e['loss']}" for e in log if not math.isfinite(e["loss"])]
    if rec["card_vs_cpu"]["outside_limits"]:
        bad.append(f"the small UNet3D on the card disagrees with the CPU ({rec['card_vs_cpu']['outside_limits']})")
    if tr["params"] != UNET_PARAMS:
        bad.append(f"{tr['params']} parameters, the JAX package has {UNET_PARAMS}")
    if [e["step"] for e in first["log"]] != [0, 1, 2] or tr["resumed_at"] != 3 or tr["resumed_log_steps"] != [3]:
        bad.append(f"steps {[e['step'] for e in first['log']]}, resumed at {tr['resumed_at']} "
                   f"({tr['resumed_log_steps']})")
    if not finite or rec["sample"]["shapes"] != [[2 * DIFF_RES] * 3 + [4], [4 * DIFF_RES] * 3]:
        bad.append(f"sample finite {finite}, shapes {rec['sample']['shapes']}")
    if faces["baked_shape0"] != rec["roundtrip"][0]["faces"]:
        bad.append(f"baked grid decodes to {faces['baked_shape0']} faces, round trip {rec['roundtrip'][0]['faces']}")
    if "sample_0000.obj" not in rec["decode"]["objs"]:
        bad.append(f"no OBJ of the sample: {rec['decode']['objs']}")
    rec["seconds"] = time.time() - t_phase
    print(f"diffusion phase: {rec['seconds']:.1f} s")
    if bad:
        raise RuntimeError("phase 8 (diffusion path) failed: " + "; ".join(bad))
    return rec


# Phase 9: G-Shell on FlexiCubes at the full width of configs/deepfashion_mc_80.json
# (voxel grid 80, 1024², n_samples 24, batch 2, the SDF MLP 256 x 6 with a
# skip at 3 and PE 6, eikonal, the default hash grid, mesh-splat shadows, the
# bilateral denoiser).  Only depth is cut:
FLEXI_CONFIG = os.path.join(ROOT, "configs", "deepfashion_mc_80.json")
FLEXI_OUT = os.path.join(ROOT, "out", "chip_smoke", "flexi")  # gitignored
FLEXI_RES = 1024
FLEXI_GT_VIEWS, FLEXI_EVAL_VIEWS = 8, 4
# The per-view recomputation (view_batch_mode "map_remat", the default)
# saves no memory at this width and costs about a fifth of a step (PERF.md
# section 6), so this phase runs "map".
FLEXI_SETTINGS = {"view_batch_mode": "map"}
FLEXI_CUTS = ["3 iterations (2, then 1 resumed) in place of 5000",
              f"{FLEXI_GT_VIEWS} ground-truth views in place of 64 (train_gshell.GT_VIEWS)",
              f"{FLEXI_EVAL_VIEWS} held-out eval views in place of 16",
              "the port's synthetic skirt in place of DeepFashion images (none are in the repository)"]


def flexi_target(dev, res: int = FLEXI_RES) -> dict:
    """Two cameras (front, and 2 units to the side) on a 0.3-radius disk
    mask at ``res``², batch 2, as the FlexiCubes config trains."""
    import torch

    from gshell_tpu_torch.ops import math as gm

    proj = gm.perspective(math.radians(45.0), 1.0, 0.1, 1000.0, device=dev)
    mvps, campos = [], []
    for eye in ([0.0, 0.4, 2.5], [2.0, 0.6, 1.4]):
        eye_t = torch.tensor(eye, device=dev)
        mvps.append(proj @ gm.lookat(eye_t, torch.zeros(3, device=dev), torch.tensor([0.0, 1.0, 0.0], device=dev)))
        campos.append(eye_t)
    ys, xs = torch.meshgrid(torch.arange(res, device=dev), torch.arange(res, device=dev), indexing="ij")
    disk = (torch.sqrt((xs - res / 2) ** 2 + (ys - res / 2) ** 2) < 0.3 * res).float()
    mask = disk[None, ..., None].repeat(2, 1, 1, 1)
    return {"mvp": torch.stack(mvps), "campos": torch.stack(campos),
            "img": torch.cat([0.5 * mask.repeat(1, 1, 1, 3), mask], -1),
            "background": torch.zeros((2, res, res, 3), device=dev)}


def flexi_point(dev, seed: int = SEED):
    """The FlexiCubes step at the full width of ``FLEXI_CONFIG``, on ``dev``:
    its ``Reconstructor``, a state after the config's SDF pretrain at step
    ``shadow_ramp_iters`` (shadows and denoiser sigma 2 live), the draw
    source and :func:`flexi_target` (the layout of :func:`working_point`)."""
    import torch

    from gshell_tpu_torch.train.setup import reconstructor_from_flags
    from gshell_tpu_torch.utils.config import load_flags
    from gshell_tpu_torch.utils.rng import TorchDraws

    flags = load_flags(FLEXI_CONFIG)
    rec = reconstructor_from_flags(flags, dev)
    draws = TorchDraws(torch.Generator(dev).manual_seed(seed))
    t0 = time.time()
    state = rec.init_state(draws.child("init"), pretrain_steps=flags.sdf_mlp_pretrain_steps)
    torch.cuda.synchronize()
    print(f"init_state ({flags.sdf_mlp_pretrain_steps} lattice pretrain steps): {time.time() - t0:.2f} s")
    state.step = rec.tcfg.shadow_ramp_iters
    return rec, state, draws, flexi_target(dev, flags.train_res[0])


def _sync_ms(fn):
    """(fn(), its wall ms between two synchronizations)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def flexi_layers(rec, state, target, reps: int = 5) -> dict:
    """Where a FlexiCubes step's time goes, sync-bracketed on the trained
    state: the full-lattice SDF MLP forward and backward, the extraction
    forward and backward (median of ``reps``), then one whole tick forward
    (fields, extraction, shadow field, render of every view, losses) and
    its backward, with the step's peak memory."""
    import torch

    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.utils.rng import TorchDraws

    geo, params = rec.geo, state.params_geo
    g = torch.Generator(geo.device).manual_seed(SEED)
    times = {k: [] for k in ("mlp_fwd", "mlp_bwd", "extract_fwd", "extract_bwd")}
    for _ in range(reps):
        (v_def, sdf, msdf), ms = _sync_ms(lambda: geo.fields(params))
        times["mlp_fwd"].append(ms)
        times["mlp_bwd"].append(_sync_ms(lambda: sdf.sum().backward())[1])
        leaves = [t.detach().requires_grad_(True) for t in (v_def, sdf, msdf, params["cube_weights"])]
        x, s, nu, w = leaves
        mesh, ms = _sync_ms(lambda: geo.extractor(x, s, nu, beta=w[:, :12], alpha=w[:, 12:20], gamma=w[:, 20]))
        times["extract_fwd"].append(ms)
        loss = (mesh.verts * torch.rand(mesh.verts.shape, generator=g, device=geo.device)).sum() + mesh.l_dev \
            + mesh.msdf.sum()
        times["extract_bwd"].append(_sync_ms(lambda: loss.backward())[1])
    out = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    for p in (t for grp in state.optimizers for pg in grp.param_groups for t in pg["params"]):
        p.grad = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    draws = TorchDraws(torch.Generator(geo.device).manual_seed(SEED))
    (img, depth, reg, aux), out["tick_fwd"] = _sync_ms(lambda: geo.tick(
        draws, params, state.params_mat, rec.mat_cfg, update_pdf(state.light_base), target, 1000, rec.flags,
        rec.image_loss_fn, shadow_scale=1.0, denoiser_sigma=2.0))
    out["tick_bwd"] = _sync_ms(lambda: (img + depth + reg).backward())[1]
    out["tick_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["n_surf_cubes"], out["n_faces"] = int(aux["n_surf_cubes"]), int(aux["n_faces"])
    return out


def hold_and_time_at_1024(rec, state, target, held: dict, label: str, smi: str) -> dict:
    """Both kernels on the first view of ``target`` (1024²) of the trained
    mesh of ``state``: held against their plain versions (the errors go
    into ``held``) and timed → {kernel: its times}."""
    import torch

    from gshell_tpu_torch.ops import denoiser as dn
    from gshell_tpu_torch.ops import math as gm
    from gshell_tpu_torch.ops import rasterize as rz
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.render.render import render_mesh
    from gshell_tpu_torch.utils.rng import TorchDraws

    dev = state.light_base.device
    with torch.no_grad():
        mesh = rec.geo.get_mesh(state.params_geo)
        v_clip = gm.xfm_points(mesh.verts, target["mvp"][0])
        bins = rz.bin_pairs(v_clip, mesh.faces, (FLEXI_RES, FLEXI_RES))
        held["rasterize_stage_b"] = max(held["rasterize_stage_b"], hold_stage_b(
            f"{label} mesh at {FLEXI_RES}²", (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)))
        sb = time_stage_b(bins, v_clip, mesh.faces, FLEXI_RES, f"the {label} mesh", smi)
        bufs = render_mesh(TorchDraws(torch.Generator(dev).manual_seed(SEED)).child("probe"), mesh.verts,
                           mesh.faces, mesh.v_nrm, mesh.msdf, state.params_mat, rec.mat_cfg, target["mvp"][0],
                           target["campos"][0], update_pdf(state.light_base), rec.flags._replace(use_denoiser=False))
        nrm = bufs["normal"][..., 0:3].contiguous()
        zdz = bufs["z_grad"][..., 0:2].contiguous()
        col = torch.cat([bufs["diffuse_light"][..., 0:3], bufs["specular_light"][..., 0:3]], -1).contiguous()
        held["bilateral_accumulate"] = max(held["bilateral_accumulate"], hold_bilateral(
            f"{label} view at {FLEXI_RES}²", (col, nrm, zdz, 2.0, 11, False),
            dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11)))
        st = time_stencil(col, nrm, zdz, smi)
    return {"rasterize_stage_b": sb, "bilateral_accumulate": st}


def flexi_path(smi: str, dev) -> dict:
    """Phase 9: the skirt → ``train_gshell.main --flexicubes`` with a copy of
    ``configs/deepfashion_mc_80.json`` (2 iterations, then resumed to 3) →
    ``eval_reconstruction.main`` (held-out views and Chamfer), each entry
    point counted and its kernels' first and last launches held against the
    plain versions at 1024²; then the step's layer split
    (:func:`flexi_layers`) and both kernels timed at 1024² on the trained
    mesh.  Returns the phase's record; raises on any failed check."""
    import shutil

    from gshell_tpu_torch import train_gshell
    from gshell_tpu_torch.train.reconstruct import load_state
    from gshell_tpu_torch.train.setup import reconstructor_from_flags
    from gshell_tpu_torch.utils.config import load_flags
    from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj

    t_phase = time.time()
    shutil.rmtree(FLEXI_OUT, ignore_errors=True)
    os.makedirs(FLEXI_OUT)
    obj = os.path.join(FLEXI_OUT, "skirt.obj")
    write_obj(obj, *skirt())
    with open(FLEXI_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(FLEXI_SETTINGS, save_interval=2)
    cfg_path = os.path.join(FLEXI_OUT, "deepfashion_mc_80_smoke.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    run = os.path.join(FLEXI_OUT, "run")
    state_path = os.path.join(run, "state.pt")
    common = ["--config", cfg_path, "--ref-mesh", obj, "--out-dir", run, "--log-interval", "1", "--flexicubes",
              "--device", str(dev)]
    print("flexi cuts: " + "; ".join(FLEXI_CUTS) + f"; settings {json.dumps(FLEXI_SETTINGS)}")

    gt_views, train_gshell.GT_VIEWS = train_gshell.GT_VIEWS, FLEXI_GT_VIEWS
    try:
        with KernelTaps() as taps:
            ep = EntryPoints(taps)
            first = ep.train(common + ["--iter", "2"], "flexi train (ground truth, then train step 1)")
            resumed = ep.train(common + ["--iter", "3", "--resume"],
                               "flexi resumed train (ground truth, then train step 2)")
            ev = ep.evaluate(["--state", state_path, "--config", cfg_path, "--device", str(dev),
                              "--synthetic-ref-mesh", obj, "--gt-mesh", obj, "--gt-unit-size",
                              "--n-views", str(FLEXI_EVAL_VIEWS), "--out-dir", os.path.join(run, "validate")],
                             f"flexi eval (held-out ground truth, then eval view {FLEXI_EVAL_VIEWS - 1})")
    finally:
        train_gshell.GT_VIEWS = gt_views
    if set(ep.held) != KERNELS_HELD:
        raise RuntimeError(f"phase 9 held only {sorted(ep.held)} against the plain versions")
    state_bytes = os.path.getsize(state_path)

    log = first["log"] + resumed["log"]
    for e in log:
        print(f"flexi step {e['it']}: total {e['total']:.6f} img {e['img_loss']:.6f} reg {e['reg_loss']:.6f} "
              f"l_dev {e['l_dev']:.6f} n_surf_cubes {int(e['n_surf_cubes'])} n_crossing_edges "
              f"{int(e['n_crossing_edges'])} n_faces {int(e['n_faces'])} overflow cube/edge/face "
              f"{int(e['cube_slot_overflow'])}/{int(e['edge_slot_overflow'])}/{int(e['face_cap_overflow'])} "
              f"raster_dropped {int(e['raster_dropped'])} px_dropped {int(e['px_dropped'])} nonfinite_grads "
              f"{int(e['nonfinite_grads'])} sdf_net |grad| {e['sdf_net_grad_norm']:.4e} peak so far "
              f"{e['peak_gib']:.2f} GiB splat cells {int(e['splat_cells'])}, "
              f"{e['splat_samples_per_cell']:.2f} samples/cell, {int(e['splat_singletons'])} singletons | "
              f"{e['s']:.3f} s/step  [{smi}]")
    steps = [e["s"] for e in log]
    rec_out = {
        "cuts": FLEXI_CUTS, "settings": FLEXI_SETTINGS, "gt_views": first["gt_views"], "gt_s_per_view": first["gt_seconds"] / first["gt_views"],
        "gt_s_per_view_resumed": resumed["gt_seconds"] / resumed["gt_views"], "steps_s": steps,
        "peak_gib": max(first["peak"], resumed["peak"]), "state_bytes": state_bytes,
        "first_run_seconds": first["seconds"], "resumed_run_seconds": resumed["seconds"],
        "resumed_at": resumed["start_it"], "eval_seconds": ev["seconds"], "psnr": ev.get("psnr"),
        "chamfer": ev.get("chamfer"), "final_faces": resumed["final_faces"],
        "nonfinite_grads": [int(e["nonfinite_grads"]) for e in log],
        "sdf_net_grad_norm": [e["sdf_net_grad_norm"] for e in log],
        "launches": {"flexi_gt_train": first["launches"]["dataset"], "flexi_train": first["launches"]["train"],
                     "flexi_gt_resumed": resumed["launches"]["dataset"],
                     "flexi_train_resumed": resumed["launches"]["train"],
                     "flexi_gt_eval": ev["launches"]["ground_truth"], "flexi_eval": ev["launches"]["synthetic"]},
        "held_max_abs_err": ep.held,
    }
    print(f"flexi ground truth: {first['gt_views']} views at {FLEXI_RES}² in {first['gt_seconds']:.2f} s "
          f"({rec_out['gt_s_per_view']:.4f} s/view, mesh load included); resumed run "
          f"{rec_out['gt_s_per_view_resumed']:.4f} s/view  [{smi}]")
    print(f"flexi train at voxel 80, {FLEXI_RES}², n_samples 24, batch 2: steps {[round(x, 3) for x in steps]} s "
          f"(the last holds a snapshot); peak memory "
          f"{rec_out['peak_gib']:.2f} GiB (each train run, ground truth and SDF pretrain included); state.pt "
          f"{state_bytes} bytes; the first run {first['seconds']:.1f} s (ground truth, SDF pretrain, 2 steps, "
          f"state), the resumed {resumed['seconds']:.1f} s; resumed at iter {resumed['start_it']}; final OBJ "
          f"{resumed['final_faces']} faces  [{smi}]")
    print(f"flexi eval: {ev['seconds']:.2f} s for {FLEXI_EVAL_VIEWS} held-out views + Chamfer; PSNR "
          f"{ev.get('psnr')} dB, MSE {ev.get('mse')}, Chamfer-L2 {ev.get('chamfer')}  [{smi}]")
    print(f"flexi launches by path: {json.dumps(rec_out['launches'])}")

    # ---- the step's layers and both kernels at 1024² on the trained state ----
    flags = load_flags(cfg_path)
    rec = reconstructor_from_flags(flags, dev)
    state, _ = load_state(rec, state_path)
    target = flexi_target(dev)
    layers = flexi_layers(rec, state, target)
    rec_out["layers_ms"] = layers
    print(f"flexi layers at voxel 80 (sync-bracketed): SDF MLP on the {rec.geo.grid.n_verts}-vertex lattice "
          f"forward {layers['mlp_fwd']:.2f} ms, backward {layers['mlp_bwd']:.2f} ms; extraction forward "
          f"{layers['extract_fwd']:.2f} ms, backward {layers['extract_bwd']:.2f} ms; one tick at {FLEXI_RES}² "
          f"batch 2 forward {layers['tick_fwd']:.1f} ms, backward {layers['tick_bwd']:.1f} ms, peak "
          f"{layers['tick_peak_gib']:.2f} GiB; n_surf_cubes {layers['n_surf_cubes']}, n_faces "
          f"{layers['n_faces']}  [{smi}]")

    rec_out["kernels_1024"] = hold_and_time_at_1024(rec, state, target, ep.held, "flexi", smi)

    bad = [f"step {e['it']} {k}" for e in log for k in ("total", "img_loss", "reg_loss", "l_dev") if not _finite(e[k])]
    bad += [f"step {e['it']}: n_surf_cubes {e['n_surf_cubes']}, n_faces {e['n_faces']}, raster_dropped "
            f"{e['raster_dropped']}, overflow {e['cube_slot_overflow']}/{e['edge_slot_overflow']}/"
            f"{e['face_cap_overflow']}" for e in log
            if e["n_surf_cubes"] <= 0 or e["n_faces"] <= 0 or e["raster_dropped"] != 0
            or e["cube_slot_overflow"] or e["edge_slot_overflow"] or e["face_cap_overflow"]]
    bad += [f"step {e['it']}: sdf_net gradient norm {e['sdf_net_grad_norm']}" for e in log
            if not e["sdf_net_grad_norm"] > 0]
    if resumed["start_it"] != 2 or [e["it"] for e in resumed["log"]] != [2]:
        bad.append(f"resumed run started at {resumed['start_it']} ({[e['it'] for e in resumed['log']]})")
    if resumed["final_faces"] <= 0:
        bad.append(f"final OBJ has {resumed['final_faces']} faces")
    if not (_finite(ev.get("psnr")) and _finite(ev.get("chamfer"))):
        bad.append(f"eval PSNR {ev.get('psnr')}, Chamfer {ev.get('chamfer')}")
    bad += unlaunched(rec_out["launches"])
    rec_out["seconds"] = time.time() - t_phase
    print(f"flexi phase: {rec_out['seconds']:.1f} s")
    if bad:
        raise RuntimeError("phase 9 (FlexiCubes path) failed: " + "; ".join(bad))
    return rec_out


# Phase 10: the second surface layer at the full width of the skirt config
# (configs/synthetic_skirt_512_shadowed.json: 512², tet grid 96, n_samples 8,
# batch 2, mesh-splat shadows, view_batch_mode "map") with two-layer ground
# truth and the second-layer image and depth losses.  Only depth is cut:
SECOND_OUT = os.path.join(ROOT, "out", "chip_smoke", "second_layer")  # gitignored
SECOND_GT_VIEWS, SECOND_EVAL_VIEWS = 16, 4
SECOND_SETTINGS = {"layers": 2, "use_img_2nd_layer": True, "use_depth": True, "use_depth_2nd_layer": True}
SECOND_CUTS = ["3 iterations (2, then 1 resumed) in place of 3000",
               f"{SECOND_GT_VIEWS} ground-truth views in place of 64 (train_gshell.GT_VIEWS)",
               f"{SECOND_EVAL_VIEWS} held-out eval views in place of 16"]
PEEL_TIE_TOL = 1e-6  # |dz| of two candidates that stage B's and the scan's depth rounding may order either way


def hold_peel(rec, state, mvp, smi: str) -> dict:
    """On the view ``mvp`` of the mesh of ``state``: the scan oracle's first
    two layers (``rasterize_peel``) against the stage-B kernel's raster and
    the binned two layers (``rasterize_tiled_peel``: stage A once, the
    kernel, then ``stage_b_second`` given its winners); a pixel may differ
    only where the two candidates' depths tie within ``PEEL_TIE_TOL``.
    Times the binned one- and two-layer passes, the second layer's own pass
    and the scan.  Raises on an unexplained difference."""
    import torch

    from gshell_tpu_torch.ops import math as gm
    from gshell_tpu_torch.ops import rasterize as rz

    with torch.no_grad():
        mesh = rec.geo.get_mesh(state.params_geo)
        faces = mesh.faces[: int(mesh.n_faces)]
        v_clip = gm.xfm_points(mesh.verts, mvp)
        res = tuple(rec.flags.resolution)
        scan, scan_ms = _sync_ms(lambda: rz.rasterize_peel(v_clip, faces, res, n_layers=2))
        best = lambda fn: min(_sync_ms(fn)[1] for _ in range(3))
        kernel = rz.rasterize_tiled(v_clip, faces, res)
        binned = rz.rasterize_tiled_peel(v_clip, faces, res)
        bins = rz.bin_pairs(v_clip, faces, res)
        args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
        first_id = rz.rasterize_stage_b(*args)[1]
        out = {"faces": int(faces.shape[0]), "scan_ms": scan_ms,
               "binned_layer1_ms": best(lambda: rz.rasterize_tiled(v_clip, faces, res)),
               "binned_peel_ms": best(lambda: rz.rasterize_tiled_peel(v_clip, faces, res)),
               "second_pass_ms": best(lambda: rz.stage_b_second(*args, first_id)),
               "layer1_px": int((scan[0].tri_id > 0).sum()), "layer2_px": int((scan[1].tri_id > 0).sum()),
               "stage_b_vs_scan": rz.layer_differences(kernel, scan[0], v_clip, faces, PEEL_TIE_TOL),
               "binned_layer1_vs_scan": rz.layer_differences(binned[0], scan[0], v_clip, faces, PEEL_TIE_TOL),
               "binned_layer2_vs_scan": rz.layer_differences(binned[1], scan[1], v_clip, faces, PEEL_TIE_TOL)}
    print(f"peel at {res[0]}x{res[1]} on the trained mesh ({out['faces']} faces; layer 1 {out['layer1_px']} px, "
          f"layer 2 {out['layer2_px']} px): stage-B kernel vs scan layer 1 {out['stage_b_vs_scan']}; binned "
          f"layer 1 {out['binned_layer1_vs_scan']}, layer 2 {out['binned_layer2_vs_scan']} (tie tol "
          f"{PEEL_TIE_TOL}); binned one-layer pass {out['binned_layer1_ms']:.2f} ms, two-layer pass "
          f"{out['binned_peel_ms']:.2f} ms (the second layer's own {out['second_pass_ms']:.2f} ms), scan "
          f"{scan_ms:.1f} ms  [{smi}]")
    bad = [k for k in ("stage_b_vs_scan", "binned_layer1_vs_scan", "binned_layer2_vs_scan") if out[k]["unexplained"]]
    if bad or out["layer2_px"] == 0:
        raise RuntimeError(f"phase 10: the binned layers disagree with the scan oracle beyond ties ({bad}), "
                           f"or the second layer is empty ({out['layer2_px']} px)")
    return out


def second_layer_path(smi: str, dev) -> dict:
    """Phase 10: the skirt → ``train_gshell.main`` with the skirt config plus
    ``SECOND_SETTINGS`` (2 iterations, then resumed to 3) →
    ``eval_reconstruction.main``, each entry point counted and its kernels'
    first and last launches held against the plain versions; then
    :func:`hold_peel` on the trained mesh's front view.  Returns the phase's
    record; raises on any failed check."""
    import shutil

    from gshell_tpu_torch import train_gshell
    from gshell_tpu_torch.train.reconstruct import load_state
    from gshell_tpu_torch.train.setup import reconstructor_from_flags
    from gshell_tpu_torch.utils.config import load_flags
    from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj

    t_phase = time.time()
    shutil.rmtree(SECOND_OUT, ignore_errors=True)
    os.makedirs(SECOND_OUT)
    obj = os.path.join(SECOND_OUT, "skirt.obj")
    write_obj(obj, *skirt())
    with open(CLI_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(SECOND_SETTINGS, save_interval=2)
    cfg_path = os.path.join(SECOND_OUT, "skirt_two_layers.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    run = os.path.join(SECOND_OUT, "run")
    state_path = os.path.join(run, "state.pt")
    common = ["--config", cfg_path, "--ref-mesh", obj, "--out-dir", run, "--log-interval", "1",
              "--device", str(dev)]
    print("second-layer cuts: " + "; ".join(SECOND_CUTS) + f"; settings {json.dumps(SECOND_SETTINGS)}")

    gt_views, train_gshell.GT_VIEWS = train_gshell.GT_VIEWS, SECOND_GT_VIEWS
    try:
        with KernelTaps() as taps:
            ep = EntryPoints(taps)
            first = ep.train(common + ["--iter", "2"], "second-layer train (ground truth, then train step 1)")
            resumed = ep.train(common + ["--iter", "3", "--resume"],
                               "second-layer resumed train (ground truth, then train step 2)")
            ev = ep.evaluate(["--state", state_path, "--config", cfg_path, "--device", str(dev),
                              "--synthetic-ref-mesh", obj, "--gt-mesh", obj, "--gt-unit-size",
                              "--n-views", str(SECOND_EVAL_VIEWS), "--out-dir", os.path.join(run, "validate")],
                             f"second-layer eval (held-out ground truth, then eval view {SECOND_EVAL_VIEWS - 1})")
    finally:
        train_gshell.GT_VIEWS = gt_views
    if set(ep.held) != KERNELS_HELD:
        raise RuntimeError(f"phase 10 held only {sorted(ep.held)} against the plain versions")

    log = first["log"] + resumed["log"]
    for e in log:
        print(f"second-layer step {e['it']}: total {e['total']:.6f} img {e['img_loss']:.6f} depth "
              f"{e['depth_loss']:.6f} reg {e['reg_loss']:.6f} n_valid_tets {int(e['n_valid_tets'])} n_faces "
              f"{int(e['n_faces'])} overflow tet/edge {int(e['tet_slot_overflow'])}/{int(e['edge_slot_overflow'])} "
              f"raster_dropped {int(e['raster_dropped'])} px_dropped {int(e['px_dropped'])} nonfinite_grads "
              f"{int(e['nonfinite_grads'])} sdf_net |grad| {e['sdf_net_grad_norm']:.4e} | {e['s']:.3f} s/step, "
              f"peak so far {e['peak_gib']:.2f} GiB  [{smi}]")
    rec_out = {
        "cuts": SECOND_CUTS, "settings": SECOND_SETTINGS, "gt_views": first["gt_views"],
        "gt_s_per_view": first["gt_seconds"] / first["gt_views"],
        "gt_s_per_view_resumed": resumed["gt_seconds"] / resumed["gt_views"],
        "steps_s": [e["s"] for e in log], "peak_gib": max(first["peak"], resumed["peak"]),
        "depth_loss": [e["depth_loss"] for e in log], "img_loss": [e["img_loss"] for e in log],
        "nonfinite_grads": [int(e["nonfinite_grads"]) for e in log],
        "first_run_seconds": first["seconds"], "resumed_run_seconds": resumed["seconds"],
        "resumed_at": resumed["start_it"], "eval_seconds": ev["seconds"], "psnr": ev.get("psnr"),
        "chamfer": ev.get("chamfer"),
        "launches": {"second_gt_train": first["launches"]["dataset"], "second_train": first["launches"]["train"],
                     "second_gt_resumed": resumed["launches"]["dataset"],
                     "second_train_resumed": resumed["launches"]["train"],
                     "second_gt_eval": ev["launches"]["ground_truth"], "second_eval": ev["launches"]["synthetic"]},
        "held_max_abs_err": ep.held,
    }
    print(f"second-layer ground truth: {first['gt_views']} two-layer views at {RES}² in {first['gt_seconds']:.2f} s "
          f"({rec_out['gt_s_per_view']:.4f} s/view, mesh load and shadow field included); resumed run "
          f"{rec_out['gt_s_per_view_resumed']:.4f} s/view  [{smi}]")
    print(f"second-layer train at grid 96, {RES}², n_samples 8, batch 2: steps "
          f"{[round(x, 3) for x in rec_out['steps_s']]} s (the last holds a snapshot); peak memory "
          f"{rec_out['peak_gib']:.2f} GiB (each train run, ground truth and SDF pretrain included); resumed at "
          f"iter {resumed['start_it']}; eval {ev['seconds']:.2f} s for {SECOND_EVAL_VIEWS} views, PSNR "
          f"{ev.get('psnr')} dB, Chamfer-L2 {ev.get('chamfer')}  [{smi}]")
    print(f"second-layer launches by path: {json.dumps(rec_out['launches'])}")

    rec = reconstructor_from_flags(load_flags(cfg_path), dev)
    state, _ = load_state(rec, state_path)
    rec_out["peel"] = hold_peel(rec, state, flexi_target(dev, RES)["mvp"][0], smi)

    bad = [f"step {e['it']} {k}" for e in log for k in ("total", "img_loss", "depth_loss", "reg_loss")
           if not _finite(e[k])]
    bad += [f"step {e['it']}: depth_loss {e['depth_loss']}" for e in log if not e["depth_loss"] > 0]
    bad += [f"step {e['it']}: n_faces {e['n_faces']}, raster_dropped {e['raster_dropped']}, px_dropped "
            f"{e['px_dropped']}, overflow {e['tet_slot_overflow']}/{e['edge_slot_overflow']}" for e in log
            if e["n_faces"] <= 0 or e["raster_dropped"] or e["px_dropped"] or e["tet_slot_overflow"]
            or e["edge_slot_overflow"]]
    if resumed["start_it"] != 2 or [e["it"] for e in resumed["log"]] != [2]:
        bad.append(f"resumed run started at {resumed['start_it']} ({[e['it'] for e in resumed['log']]})")
    if not (_finite(ev.get("psnr")) and _finite(ev.get("chamfer"))):
        bad.append(f"eval PSNR {ev.get('psnr')}, Chamfer {ev.get('chamfer')}")
    bad += unlaunched(rec_out["launches"])
    rec_out["seconds"] = time.time() - t_phase
    print(f"second-layer phase: {rec_out['seconds']:.1f} s")
    if bad:
        raise RuntimeError("phase 10 (second layer) failed: " + "; ".join(bad))
    return rec_out


# Phase 11: the textured path.  Phase 7's skirt config at full width (512²,
# tet grid 96, n_samples 8, batch 2, shadows) plus supersampling and
# denoising after modulation; the bake at 1024².  Only depth is cut:
TEXTURED_OUT = os.path.join(ROOT, "out", "chip_smoke", "textured")  # gitignored
TEXTURED_GT_VIEWS, BAKE_RES = 16, 1024
TEXTURED_SETTINGS = {"spp": 2, "denoiser_demodulate": False}
TEXTURED_CUTS = ["2 iterations in place of 3000, then a resumed call that trains none and bakes",
                 f"{TEXTURED_GT_VIEWS} ground-truth views in place of 64 (train_gshell.GT_VIEWS)"]
# the baked material: the hash grid's coarsest level drawn in ±30 from the
# seed (utils.synthetic.vary_material), so that kd varies across the skirt
VARY = {"seed": SEED, "levels": 1, "scale": 30.0}
PSNR_GATE, CONTROL_MARGIN = 20.0, 3.0  # dB


def kd_psnr(a, b) -> float:
    """PSNR of two renders' kd on the pixels both cover fully."""
    import torch

    from gshell_tpu_torch.ops.math import mse_to_psnr

    both = (a["mask"][..., 0] == 1) & (b["mask"][..., 0] == 1)
    if int(both.sum()) == 0:
        raise RuntimeError("the baked and the neural renders share no covered pixel")
    return float(mse_to_psnr(torch.mean((a["kd"][..., :3] - b["kd"][..., :3])[both] ** 2)))


def textured_round_trip(run: str, cfg_path: str, dev, mvp, campos) -> dict:
    """The baked asset in ``run`` loaded back (``train_gshell.load_baked``:
    OBJ, MTL, PNGs, ``merge_materials``) and rendered on one view through
    the Texture2D branch under ``kd``, ``pbr`` (denoiser on), ``normal`` and
    ``ks``, with the run's flags (the config's spp and denoising); the
    neural material of the run's state on its own mesh and the same view
    under ``kd``; the atlas flipped in v under ``kd``.  The launch counts
    are set to 0 just before the ``kd`` and ``pbr`` renders and read just
    after.  → the PSNRs of the baked and the flipped kd against the neural
    kd, each BSDF's buffers' finiteness and whether it emitted light
    buffers, and those two renders' launches."""
    import torch

    from gshell_tpu_torch import train_gshell
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.render.render import render_mesh
    from gshell_tpu_torch.render.texture import create_trainable
    from gshell_tpu_torch.train.reconstruct import load_state
    from gshell_tpu_torch.train.setup import kernel_launches, reconstructor_from_flags
    from gshell_tpu_torch.utils.config import load_flags
    from gshell_tpu_torch.utils.rng import TorchDraws

    rec = reconstructor_from_flags(load_flags(cfg_path), dev)
    state, _ = load_state(rec, os.path.join(run, "state.pt"))
    light = update_pdf(state.light_base.detach())
    mesh, uvs, tfaces, material = train_gshell.load_baked(run, dev)
    baked_geom = (mesh.v_pos, mesh.t_pos_idx, mesh.v_nrm)
    uv = {"v_tex": uvs, "t_tex_idx": tfaces}

    def render(geom, mat, bsdf, **uv_kw):
        return render_mesh(TorchDraws(torch.Generator(dev).manual_seed(SEED)), *geom, None, mat, rec.mat_cfg, mvp,
                           campos, light, rec.flags._replace(bsdf=bsdf, shade_budget=None), **uv_kw)

    out = {"faces": int(mesh.t_pos_idx.shape[0]), "atlas": tuple(material.kd.base.shape)}
    with torch.no_grad():
        zero_launches()
        bufs = {bsdf: render(baked_geom, material, bsdf, **uv) for bsdf in ("kd", "pbr")}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["launches"] = kernel_launches()
        bufs.update({bsdf: render(baked_geom, material, bsdf, **uv) for bsdf in ("normal", "ks")})
        neural = rec.geo.get_mesh(state.params_geo)
        neural_kd = render((neural.verts, neural.faces, neural.v_nrm), state.params_mat, "kd")
        flipped = material._replace(kd=create_trainable(material.kd.base.flip(0)))
        out["psnr"] = kd_psnr(bufs["kd"], neural_kd)
        out["psnr_v_flipped"] = kd_psnr(render(baked_geom, flipped, "kd", **uv), neural_kd)
    out["finite"] = {b: all(bool(torch.isfinite(v).all()) for v in buf.values()
                            if isinstance(v, torch.Tensor) and v.is_floating_point()) for b, buf in bufs.items()}
    out["light_buffers"] = {b: "diffuse_light" in buf for b, buf in bufs.items()}
    out["covered_px"] = int((bufs["kd"]["mask"][..., 0] == 1).sum())
    return out


def textured_path(smi: str, dev) -> dict:
    """Phase 11: the skirt → ``train_gshell.main`` with the skirt config plus
    ``TEXTURED_SETTINGS`` (2 iterations), its state's material given a
    varied kd (``VARY``), then a resumed call with ``--bake-texture
    BAKE_RES`` that trains nothing and bakes; each entry point counted and
    its kernels' first and last launches held against the plain versions
    (stage B at 1024², the 3-channel stencil forward and transposed at
    1024²); then :func:`textured_round_trip` on the front view, its two
    renders counted and held as well.  Returns the phase's record; raises
    on any failed check."""
    import shutil

    import torch

    from gshell_tpu_torch import train_gshell
    from gshell_tpu_torch.utils.synthetic import vary_material
    from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj

    t_phase = time.time()
    shutil.rmtree(TEXTURED_OUT, ignore_errors=True)
    os.makedirs(TEXTURED_OUT)
    obj = os.path.join(TEXTURED_OUT, "skirt.obj")
    write_obj(obj, *skirt())
    with open(CLI_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(TEXTURED_SETTINGS, save_interval=0)
    cfg_path = os.path.join(TEXTURED_OUT, "skirt_textured.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    run = os.path.join(TEXTURED_OUT, "run")
    state_path = os.path.join(run, "state.pt")
    common = ["--config", cfg_path, "--ref-mesh", obj, "--out-dir", run, "--log-interval", "1",
              "--device", str(dev)]
    print("textured cuts: " + "; ".join(TEXTURED_CUTS) + f"; settings {json.dumps(TEXTURED_SETTINGS)}, "
          f"bake {BAKE_RES}², material {json.dumps(VARY)}")

    view = flexi_target(dev, RES)
    gt_views, train_gshell.GT_VIEWS = train_gshell.GT_VIEWS, TEXTURED_GT_VIEWS
    try:
        with KernelTaps() as taps:
            ep = EntryPoints(taps)
            first = ep.train(common + ["--iter", "2"], "textured train (ground truth, then train step 1)")
            record = torch.load(state_path, weights_only=True)
            record["params_mat"] = vary_material(record["params_mat"], **VARY)
            torch.save(record, state_path)
            baked = ep.train(common + ["--iter", "2", "--resume", "--bake-texture", str(BAKE_RES)],
                             "textured bake (ground truth)")
            taps.clear()
            trip = textured_round_trip(run, cfg_path, dev, view["mvp"][0], view["campos"][0])
            ep.hold("textured round trip (the pbr render of the baked asset)",
                    {"taps": taps.taps, "launches": {}})
    finally:
        train_gshell.GT_VIEWS = gt_views
    if set(ep.held) != KERNELS_HELD:
        raise RuntimeError(f"phase 11 held only {sorted(ep.held)} against the plain versions")

    log, bake = first["log"], baked["bake"]
    for e in log:
        print(f"textured step {e['it']}: total {e['total']:.6f} img {e['img_loss']:.6f} reg {e['reg_loss']:.6f} "
              f"n_faces {int(e['n_faces'])} raster_dropped {int(e['raster_dropped'])} px_dropped "
              f"{int(e['px_dropped'])} nonfinite_grads {int(e['nonfinite_grads'])} | {e['s']:.3f} s/step, "
              f"peak so far {e['peak_gib']:.2f} GiB  [{smi}]")
    rec_out = {
        "cuts": TEXTURED_CUTS, "settings": TEXTURED_SETTINGS, "bake_res": BAKE_RES, "material": VARY,
        "gt_views": first["gt_views"], "gt_s_per_view": first["gt_seconds"] / first["gt_views"],
        "steps_s": [e["s"] for e in log], "peak_gib": first["peak"],
        "nonfinite_grads": [int(e["nonfinite_grads"]) for e in log], "img_loss": [e["img_loss"] for e in log],
        "bake": bake, "bake_run_seconds": baked["seconds"], "round_trip": {k: v for k, v in trip.items()
                                                                         if k != "launches"},
        "launches": {"textured_gt_train": first["launches"]["dataset"], "textured_train": first["launches"]["train"],
                     "textured_gt_bake": baked["launches"]["dataset"], "textured_render": trip["launches"]},
        "held_max_abs_err": ep.held,
    }
    print(f"textured ground truth: {first['gt_views']} views at {RES}² spp 2 ({2 * RES}² rasters) in "
          f"{first['gt_seconds']:.2f} s ({rec_out['gt_s_per_view']:.4f} s/view)  [{smi}]")
    print(f"textured train at grid 96, {RES}² spp 2, modulated denoise: steps "
          f"{[round(x, 3) for x in rec_out['steps_s']]} s; peak memory {first['peak']:.2f} GiB (ground truth and "
          f"SDF pretrain included); nonfinite_grads {rec_out['nonfinite_grads']}  [{smi}]")
    print(f"textured bake at {BAKE_RES}²: {bake.get('faces')} faces, {bake.get('charts')} charts, "
          f"{bake.get('uv_verts')} UV vertices, {100 * bake.get('covered', 0):.2f} % of the atlas covered, finite "
          f"{bake.get('finite')}; unwrap {bake.get('unwrap_seconds', 0):.2f} s (host), render_uv "
          f"{bake.get('render_uv_seconds', 0):.2f} s; the resumed call {baked['seconds']:.2f} s  [{smi}]")
    print(f"textured round trip at {RES}² ({trip['covered_px']} px covered by both): baked kd PSNR "
          f"{trip['psnr']:.3f} dB (gate {PSNR_GATE}), v-flipped {trip['psnr_v_flipped']:.3f} dB (at least "
          f"{CONTROL_MARGIN} lower); finite {trip['finite']}; light buffers {trip['light_buffers']}  [{smi}]")
    print(f"textured launches by path: {json.dumps(rec_out['launches'])}")

    bad = [f"step {e['it']} {k}" for e in log for k in ("total", "img_loss", "reg_loss") if not _finite(e[k])]
    bad += [f"step {e['it']}: n_faces {e['n_faces']}, raster_dropped {e['raster_dropped']}, px_dropped "
            f"{e['px_dropped']}, nonfinite_grads {e['nonfinite_grads']}" for e in log
            if e["n_faces"] <= 0 or e["raster_dropped"] or e["px_dropped"] or e["nonfinite_grads"]]
    missing = [n for n in ("texture_kd.png", "texture_ks.png", "mesh_textured.obj", "baked.mtl")
               if not os.path.exists(os.path.join(run, n))]
    if missing or not bake.get("finite") or not bake.get("covered", 0) > 0:
        bad.append(f"bake: missing {missing}, finite {bake.get('finite')}, covered {bake.get('covered')}")
    if baked["log"] or baked["start_it"] != 2:
        bad.append(f"the bake call trained ({baked['start_it']}, {[e['it'] for e in baked['log']]})")
    if not trip["psnr"] >= PSNR_GATE or not trip["psnr_v_flipped"] <= trip["psnr"] - CONTROL_MARGIN:
        bad.append(f"round trip: PSNR {trip['psnr']:.3f} dB (gate {PSNR_GATE}), v-flipped "
                   f"{trip['psnr_v_flipped']:.3f} dB (must be {CONTROL_MARGIN} dB lower)")
    bad += [f"{b} buffers not finite" for b, ok in trip["finite"].items() if not ok]
    bad += [f"bsdf {b} emitted light buffers" for b in ("normal", "kd", "ks") if trip["light_buffers"].get(b)]
    if not trip["light_buffers"]["pbr"]:
        bad.append("bsdf pbr emitted no light buffers")
    bad += unlaunched(rec_out["launches"])
    rec_out["seconds"] = time.time() - t_phase
    print(f"textured phase: {rec_out['seconds']:.1f} s")
    if bad:
        raise RuntimeError("phase 11 (textured path) failed: " + "; ".join(bad))
    return rec_out


# Phase 12: the other geometry fields and shadow sources.  (a) and (b): phase
# 7's skirt config at full width (512², tet grid 96, n_samples 8, batch 2,
# mesh-splat shadows, view_batch_mode "map") with a direct per-vertex SDF,
# then with an mSDF MLP; (c): phase 9's FlexiCubes config at full width
# (voxel 80, 1024², n_samples 24) with a direct SDF; (d): the legacy
# template-SDF occluder at phase 6's working point.  Only depth is cut:
FIELDS_OUT = os.path.join(ROOT, "out", "chip_smoke", "fields")  # gitignored
FIELDS_GT_VIEWS, FIELDS_EVAL_VIEWS = 16, 4
FIELDS_CUTS = ["(a) 3 iterations (2, then 1 resumed), (b) and (c) 2, in place of 3000 / 5000",
               f"(a), (b) {FIELDS_GT_VIEWS} ground-truth views in place of 64, (c) {FLEXI_GT_VIEWS}",
               f"{FIELDS_EVAL_VIEWS} held-out eval views in place of 16",
               "(d) one step per occluder from the working point's state"]
SHADOW_RAYS = 1 << 18  # rays from the cut surface in uniform directions, for the occluders' blocked share
# The trilinear march on the card may differ from the CPU's on at most this
# share of rays (each sample is eager elementwise arithmetic on both, so the
# expected count is 0; a fused contraction would move a sample by an ulp)
MARCH_TRILINEAR_MAX_DIFF = 1e-4


def _write_config(base: str, settings: dict, path: str) -> str:
    with open(base) as f:
        cfg = json.load(f)
    cfg.update(settings)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _step_lines(tag: str, log: list, smi: str) -> None:
    for e in log:
        grad = f" sdf_net |grad| {e['sdf_net_grad_norm']:.4e}" if "sdf_net_grad_norm" in e else ""
        active = int(e.get("n_valid_tets", e.get("n_surf_cubes", 0)))
        print(f"{tag} step {e['it']}: total {e['total']:.6f} img {e['img_loss']:.6f} reg {e['reg_loss']:.6f} "
              f"sdf_reg {e['sdf_reg']:.6f} eik {e['eik_loss']:.6f} active {active} n_faces {int(e['n_faces'])} "
              f"raster_dropped {int(e['raster_dropped'])} nonfinite_grads {int(e['nonfinite_grads'])}{grad} | "
              f"{e['s']:.3f} s/step, peak so far {e['peak_gib']:.2f} GiB  [{smi}]")


def _field_checks(tag: str, log: list, faces: bool = True) -> list:
    bad = [f"{tag} step {e['it']} {k}" for e in log for k in ("total", "img_loss", "reg_loss") if not _finite(e[k])]
    bad += [f"{tag} step {e['it']}: nonfinite_grads {e['nonfinite_grads']}" for e in log if e["nonfinite_grads"]]
    if faces:
        bad += [f"{tag} step {e['it']}: n_faces {e['n_faces']}, raster_dropped {e['raster_dropped']}"
                for e in log if e["n_faces"] <= 0 or e["raster_dropped"]]
    return bad


def legacy_sources(smi: str, dev) -> dict:
    """Phase 12 (d): at phase 6's working point (state step 1000), one train
    step under ``shadow_source="sdf"`` with each ``shadow_method``, each from
    the same state, its launches counted and each kernel's first and last
    launch held (the marcher's inside the MC shade's kernels).  The share of rays from the cut
    surface (uniform directions) each occluder blocks must lie strictly
    between 0 and 1 (1 is the sign fault that marks the exterior solid); the
    marcher's visibility on the card is held against the CPU's on the same
    rays, nearest exactly, trilinear to ``MARCH_TRILINEAR_MAX_DIFF``; the
    occluder builds and the lookups are timed."""
    import torch

    from gshell_tpu_torch.ops.mesh_ops import sample_surface
    from gshell_tpu_torch.ops.shade import apply_visibility, make_sdf_visibility
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
    from gshell_tpu_torch.train.setup import kernel_launches

    rec, state, draws, target = working_point(dev)
    with torch.no_grad():
        mesh = rec.geo.get_mesh(state.params_geo)
        pts = sample_surface(draws.child("rays"), mesh.verts, mesh.faces, SHADOW_RAYS, face_mask=mesh.face_valid)
        dirs = torch.nn.functional.normalize(draws.normal("dirs", (SHADOW_RAYS, 3)), dim=-1)
    out, launches, held, bad = {}, {}, {}, []
    for method in ("field", "march"):
        rec_m = Reconstructor(rec.geo, rec.mat_cfg, rec.flags,
                              TrainConfig(batch=BATCH, use_shadows=True, shadow_source="sdf", shadow_method=method))
        st = rec_m.make_state(state.params_geo, state.params_mat, state.light_base, step=state.step)
        with torch.no_grad():
            rec_m.sdf_occluder(st.params_geo)  # warm-up
            vis, build_ms = _sync_ms(lambda: rec_m.sdf_occluder(st.params_geo))
            blocked = float(1.0 - apply_visibility(vis, pts, dirs).mean())
            lookup_ms = min(_sync_ms(lambda: apply_visibility(vis, pts, dirs))[1] for _ in range(5))
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        with KernelTaps() as taps:
            m, step_ms = _sync_ms(lambda: rec_m.train_step(st, draws.child(f"legacy_{method}"), target))
        launches[f"legacy_{method}_train"] = kernel_launches()
        hold_taps(f"legacy source sdf / {method} train step", taps.taps, held)
        m = {k: float(v) for k, v in m.items()}
        out[method] = {"build_ms": build_ms, "lookup_ms": lookup_ms, "rays": SHADOW_RAYS, "blocked": blocked,
                       "step_s": step_ms / 1e3, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       **{k: m[k] for k in ("total", "img_loss", "reg_loss", "n_faces", "nonfinite_grads")}}
        print(f"legacy source sdf / {method}: occluder build {build_ms:.2f} ms, {SHADOW_RAYS} lookups "
              f"{lookup_ms:.2f} ms (wall between synchronizations), blocked share {blocked:.4f}; one step "
              f"{step_ms / 1e3:.3f} s, total {m['total']:.6f} img {m['img_loss']:.6f} reg {m['reg_loss']:.6f} "
              f"n_faces {int(m['n_faces'])} nonfinite_grads {int(m['nonfinite_grads'])}, peak "
              f"{out[method]['peak_gib']:.2f} GiB; launches {json.dumps(launches[f'legacy_{method}_train'])}  [{smi}]")
        bad += [f"legacy {method} {k} {m[k]}" for k in ("total", "img_loss", "reg_loss") if not _finite(m[k])]
        if not 0.0 < blocked < 1.0:
            bad.append(f"legacy {method}: the occluder blocks a share {blocked} of the rays")
        if method == "march":
            with torch.no_grad():
                occ = -rec.geo.sdf_lattice(st.params_geo)
                for mode in ("nearest", "trilinear"):
                    v = make_sdf_visibility(occ, rec_m.aabb_min, rec_m.aabb_size, mode=mode)
                    card = apply_visibility(v, pts, dirs).cpu()
                    cpu = apply_visibility(v._replace(grid=v.grid.cpu()), pts.cpu(), dirs.cpu())
                    n_diff = int((card != cpu).sum())
                    ms = min(_sync_ms(lambda: apply_visibility(v, pts, dirs))[1] for _ in range(5))
                    out[method][f"{mode}_card_vs_cpu_rays_differing"] = n_diff
                    out[method][f"{mode}_lookup_ms"] = ms
                    print(f"marcher {mode} (grid {v.r + 1}³, {v.n_steps} steps): card vs CPU on {SHADOW_RAYS} rays, "
                          f"{n_diff} differ; {ms:.2f} ms on the card  [{smi}]")
                    if n_diff > (0 if mode == "nearest" else MARCH_TRILINEAR_MAX_DIFF * SHADOW_RAYS):
                        bad.append(f"marcher {mode}: {n_diff} rays differ between the card and the CPU")
    out["launches"], out["held_max_abs_err"] = launches, held
    if bad:
        raise RuntimeError("phase 12 (d) (legacy shadow sources) failed: " + "; ".join(bad))
    return out


def fields_path(smi: str, dev, flexi: dict) -> dict:
    """Phase 12: (a) a direct SDF on tets through ``train_gshell.main`` (2
    iterations, resumed to 3) and ``eval_reconstruction.main``; (b) an mSDF
    MLP on tets, 2 iterations, with the share of lattice vertices it keeps
    (mSDF > 0) at init and after; (c) a direct SDF on FlexiCubes, 2
    iterations and eval, both kernels held and timed at 1024², beside phase
    9's ``flexi`` record; (d) :func:`legacy_sources`.  Every entry point
    counted, each kernel's first and last launch held.  Returns the phase's
    record; raises on any failed check."""
    import shutil

    import torch

    from gshell_tpu_torch import train_gshell
    from gshell_tpu_torch.train.reconstruct import load_state
    from gshell_tpu_torch.train.setup import reconstructor_from_flags
    from gshell_tpu_torch.utils.config import load_flags
    from gshell_tpu_torch.utils.rng import TorchDraws
    from gshell_tpu_torch.utils.synthetic_gt import skirt, write_obj

    t_phase = time.time()
    shutil.rmtree(FIELDS_OUT, ignore_errors=True)
    os.makedirs(FIELDS_OUT)
    obj = os.path.join(FIELDS_OUT, "skirt.obj")
    write_obj(obj, *skirt())
    print("fields cuts: " + "; ".join(FIELDS_CUTS))
    cfgs = {"direct": _write_config(CLI_CONFIG, {"use_sdf_mlp": False, "save_interval": 2},
                                    os.path.join(FIELDS_OUT, "skirt_direct_sdf.json")),
            "msdf_mlp": _write_config(CLI_CONFIG, {"use_msdf_mlp": True, "save_interval": 2},
                                      os.path.join(FIELDS_OUT, "skirt_msdf_mlp.json")),
            "flexi_direct": _write_config(FLEXI_CONFIG, {**FLEXI_SETTINGS, "use_sdf_mlp": False, "save_interval": 2},
                                          os.path.join(FIELDS_OUT, "deepfashion_mc_80_direct_sdf.json"))}
    runs = {k: os.path.join(FIELDS_OUT, k) for k in cfgs}
    common = lambda k: ["--config", cfgs[k], "--ref-mesh", obj, "--out-dir", runs[k], "--log-interval", "1",
                        "--device", str(dev)] + (["--flexicubes"] if k == "flexi_direct" else [])
    evaluate = lambda ep, k, label: ep.evaluate(
        ["--state", os.path.join(runs[k], "state.pt"), "--config", cfgs[k], "--device", str(dev),
         "--synthetic-ref-mesh", obj, "--gt-mesh", obj, "--gt-unit-size", "--n-views", str(FIELDS_EVAL_VIEWS),
         "--out-dir", os.path.join(runs[k], "validate")], label)
    last = f"eval view {FIELDS_EVAL_VIEWS - 1}"
    gt_views = train_gshell.GT_VIEWS
    try:
        with KernelTaps() as taps:
            ep = EntryPoints(taps)
            train_gshell.GT_VIEWS = FIELDS_GT_VIEWS
            a1 = ep.train(common("direct") + ["--iter", "2"], "direct SDF train (ground truth, then step 1)")
            a2 = ep.train(common("direct") + ["--iter", "3", "--resume"], "direct SDF resumed train (step 2)")
            a_ev = evaluate(ep, "direct", f"direct SDF eval (held-out ground truth, then {last})")
            b1 = ep.train(common("msdf_mlp") + ["--iter", "2"], "mSDF MLP train (ground truth, then step 1)")
            train_gshell.GT_VIEWS = FLEXI_GT_VIEWS
            c1 = ep.train(common("flexi_direct") + ["--iter", "2"],
                          "FlexiCubes direct SDF train (ground truth, then step 1)")
            c_ev = evaluate(ep, "flexi_direct", f"FlexiCubes direct SDF eval (held-out ground truth, then {last})")
    finally:
        train_gshell.GT_VIEWS = gt_views
    if set(ep.held) != KERNELS_HELD:
        raise RuntimeError(f"phase 12 held only {sorted(ep.held)} against the plain versions")
    bad = []

    # (a) the direct SDF
    a_log = a1["log"] + a2["log"]
    _step_lines("direct SDF", a_log, smi)
    rec_a = torch.load(os.path.join(runs["direct"], "state.pt"), map_location="cpu", weights_only=True)
    pg = rec_a["params_geo"]
    n_lat = (json.load(open(cfgs["direct"]))["gshell_grid"] + 1) ** 3
    bad += _field_checks("direct SDF", a_log)
    bad += [f"direct SDF step {e['it']}: eik_loss {e['eik_loss']}" for e in a_log if e["eik_loss"] != 0]
    if "sdf_net" in pg or tuple(pg.get("sdf", torch.zeros(0)).shape) != (n_lat,):
        bad.append(f"direct SDF snapshot holds {sorted(pg)}")
    if a2["start_it"] != 2 or [e["it"] for e in a2["log"]] != [2]:
        bad.append(f"direct SDF resumed at {a2['start_it']}")
    if not (_finite(a_ev.get("psnr")) and _finite(a_ev.get("chamfer"))):
        bad.append(f"direct SDF eval PSNR {a_ev.get('psnr')}, Chamfer {a_ev.get('chamfer')}")

    # (b) the mSDF MLP: the share of the lattice it keeps, at init and after
    _step_lines("mSDF MLP", b1["log"], smi)
    rec_b = reconstructor_from_flags(load_flags(cfgs["msdf_mlp"]), dev)
    with torch.no_grad():
        p0 = rec_b.geo.init_params(TorchDraws(torch.Generator(dev).manual_seed(0)).child("init").child("geo"))
        keep0 = float((rec_b.geo.fields(p0)[2] > 0).float().mean())
        st_b, _ = load_state(rec_b, os.path.join(runs["msdf_mlp"], "state.pt"))
        keep1 = float((rec_b.geo.fields(st_b.params_geo)[2] > 0).float().mean())
    print(f"mSDF MLP at grid {rec_b.geo.cfg.grid_res}: share of lattice vertices kept (msdf > 0) {keep0:.4f} at init, {keep1:.4f} after "
          f"{st_b.step} steps; n_faces per step {[int(e['n_faces']) for e in b1['log']]}  [{smi}]")
    bad += _field_checks("mSDF MLP", b1["log"], faces=False)
    del rec_b, st_b, p0

    # (c) the direct SDF on FlexiCubes
    _step_lines("FlexiCubes direct SDF", c1["log"], smi)
    bad += _field_checks("FlexiCubes direct SDF", c1["log"])
    bad += [f"FlexiCubes direct SDF step {e['it']}: eik_loss {e['eik_loss']}" for e in c1["log"] if e["eik_loss"]]
    if not (_finite(c_ev.get("psnr")) and _finite(c_ev.get("chamfer"))):
        bad.append(f"FlexiCubes direct SDF eval PSNR {c_ev.get('psnr')}, Chamfer {c_ev.get('chamfer')}")
    rec_c = reconstructor_from_flags(load_flags(cfgs["flexi_direct"]), dev)
    st_c, _ = load_state(rec_c, os.path.join(runs["flexi_direct"], "state.pt"))
    kernels_1024 = hold_and_time_at_1024(rec_c, st_c, flexi_target(dev), ep.held, "FlexiCubes direct SDF", smi)
    c_steps = [e["s"] for e in c1["log"]]
    print(f"FlexiCubes direct SDF at voxel {rec_c.geo.cfg.grid_res}, {FLEXI_RES}², n_samples {rec_c.flags.n_samples}, "
          f"batch {rec_c.tcfg.batch}: steps "
          f"{[round(x, 3) for x in c_steps]} s, peak {c1['peak']:.2f} GiB, against phase 9's SDF MLP steps "
          f"{[round(x, 3) for x in flexi['steps_s']]} s, peak {flexi['peak_gib']:.2f} GiB; ground truth "
          f"{c1['gt_seconds'] / c1['gt_views']:.4f} s/view; eval {c_ev['seconds']:.2f} s, PSNR {c_ev.get('psnr')} dB, "
          f"Chamfer-L2 {c_ev.get('chamfer')}  [{smi}]")
    del rec_c, st_c
    torch.cuda.empty_cache()

    # (d) the legacy sources
    legacy = legacy_sources(smi, dev)
    for k, v in legacy.pop("held_max_abs_err").items():
        ep.held[k] = max(ep.held[k], v)
    launches = {"fields_direct_gt": a1["launches"]["dataset"], "fields_direct_train": a1["launches"]["train"],
                "fields_direct_gt_resumed": a2["launches"]["dataset"],
                "fields_direct_train_resumed": a2["launches"]["train"],
                "fields_direct_gt_eval": a_ev["launches"]["ground_truth"],
                "fields_direct_eval": a_ev["launches"]["synthetic"],
                "fields_msdf_mlp_gt": b1["launches"]["dataset"], "fields_msdf_mlp_train": b1["launches"]["train"],
                "fields_flexi_direct_gt": c1["launches"]["dataset"],
                "fields_flexi_direct_train": c1["launches"]["train"],
                "fields_flexi_direct_gt_eval": c_ev["launches"]["ground_truth"],
                "fields_flexi_direct_eval": c_ev["launches"]["synthetic"], **legacy.pop("launches")}
    print(f"fields launches by path: {json.dumps(launches)}")
    bad += unlaunched(launches)
    summary = lambda log, run: {"steps_s": [e["s"] for e in log], "peak_gib": max(r["peak"] for r in run),
                                "n_faces": [int(e["n_faces"]) for e in log],
                                "nonfinite_grads": [int(e["nonfinite_grads"]) for e in log],
                                "gt_s_per_view": run[0]["gt_seconds"] / run[0]["gt_views"]}
    rec_out = {
        "cuts": FIELDS_CUTS,
        "direct_sdf": {**summary(a_log, [a1, a2]), "snapshot_keys": sorted(pg), "psnr": a_ev.get("psnr"),
                       "chamfer": a_ev.get("chamfer"), "eval_seconds": a_ev["seconds"]},
        "msdf_mlp": {**summary(b1["log"], [b1]), "kept_share_init": keep0, "kept_share_after": keep1},
        "flexi_direct_sdf": {**summary(c1["log"], [c1]), "psnr": c_ev.get("psnr"), "chamfer": c_ev.get("chamfer"),
                             "phase9_steps_s": flexi["steps_s"], "phase9_peak_gib": flexi["peak_gib"],
                             "kernels_1024": kernels_1024},
        "legacy_sources": legacy, "launches": launches, "held_max_abs_err": ep.held,
    }
    rec_out["seconds"] = time.time() - t_phase
    print(f"fields phase: {rec_out['seconds']:.1f} s")
    if bad:
        raise RuntimeError("phase 12 (fields and shadow sources) failed: " + "; ".join(bad))
    return rec_out


# ---------------------------------------------------------------------------
# Phase 13: the distributed paths (torch.distributed; gshell_tpu/parallel/).
# (a) G-MeshDiffusion data parallel: ``main_diffusion --multihost`` over
# NCCL at world size 1 at phase 8's full width against the same step without
# a group, one after the other (two full-width models do not fit together),
# with deterministic cuDNN so that both run the same algorithms; then
# ``DiffusionTrainer(mesh=)`` on two gloo ranks sharing the card on a
# narrower U-Net against one process.
# (b) ``Reconstructor(spatial=(2, 4))`` at the skirt config's full width from
# phase 7's state: one process holding all 8 cells (160 x 512 each: 128 rows
# and a 16-row halo above and below), then two gloo ranks holding 4 each;
# banded against unbanded pixels.  (c) phase 9's FlexiCubes state with
# spatial (2, 2), cells of 544 x 1024, one step in one process.
DIST_OUT = os.path.join(ROOT, "out", "chip_smoke", "distributed")  # gitignored
# The two-rank diffusion run: DiffusionTrainer at base 32 and dropout 0 (so
# that the one process and the two ranks draw the same masks), grid 32,
# global batch 2 x 2 microbatches, 2 steps.
DIST_SMALL = {"res": 32, "base_channels": 32, "batch": 2, "grad_acc": 2, "steps": 2}
BANDED_SPATIAL = (2, 4)
FLEXI_SPATIAL = (2, 2)
# Banded against unbanded (the kd BSDF, rows 1 to H - 2), by the share of
# the pixels that differ by more than 1e-4 in some channel.  JAX's rule, at
# most 1 % of them, holds the geometric buffers (mask, invdepth) here, as the
# CPU tests hold all four.  The kd and mSDF images of the trained grid-96
# skirt do not meet it on the H100: they move by more than 1e-4 on several %
# of the pixels under any rounding of the view, and ``band_mvp`` rounds the
# y row of each band's MVP (scaled by H / 160, shifted).  Where they miss
# it, they are held to at most ``BAND_FLOOR_RATIO`` times the share that the
# unbanded render moves by itself with its MVP's y row one ulp off, measured
# in the same run (the floor): the banded render moved 2.3 to 2.6 times the
# floor's share in four runs on an NVIDIA H100 80GB HBM3 at 700 W.  A band or a halo
# crop one row off fails every buffer's check.  All four buffers also keep
# 99 % of the pixels within 1e-2.
BAND_FLOOR_RATIO = 3.0
# Two gloo ranks against one process on the card, relative differences
# (diffusion: of both steps' losses and gradient norms, the first step's
# learning rate being 0; reconstruction: of the first step's total loss and
# of its gradient norms per parameter group, averaged across the ranks, as
# they reach Adam, from the same state; the second step's loss printed
# beside, since Adam's first update turns a rounding of a gradient near its
# epsilon into a step-sized one).  Bit-equality is not expected there: the
# replicated work's atomic sums (normals, splat, hash-grid backward) round
# in another order in every process, and the one process runs its
# convolutions at batch 2 where a rank runs them at 1.  A gradient that is
# not divided by the world size, or a stitch that sends back a rank's
# gradient to other ranks' pieces, is off by a factor near 2; two runs on an
# NVIDIA H100 80GB HBM3 at 700 W read 4.7e-5 and 4.3e-4 (geometry), 2.4e-6
# and 4.5e-5 (material), 1.5e-7 and 4.7e-5 (light) for the gradient norms,
# each from its own state of phase 7.
# The CPU tests hold the same comparisons to 1e-6 in deterministic
# arithmetic.
DIST_RTOL = 1e-4
DIST_GRAD_RTOL = 1e-2
DIST_CUTS = ["(a) 1 step at full width without a group and 1 with NCCL at world size 1; 2 steps at base 32, "
             "grid 32, batch 2 x 2 on 2 gloo ranks and on 1 process",
             "(b) 2 steps from phase 7's state (iteration 4, set to step 1000 so the shadows and sigma 2 are live) "
             "on 1 process and on 2 gloo ranks, on phase 9's synthetic disk target at 512²",
             "(c) 1 step from phase 9's state on 1 process"]


def _peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2**30 if torch.device(dev).type == "cuda" else 0.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def banded_steps(job: dict, group) -> tuple:
    """``job["steps"]`` train steps of ``Reconstructor(spatial=job["spatial"])``
    over ``group`` (``None``: one process renders every cell) from the state
    at ``job["state"]`` (set to step ``shadow_ramp_iters``) on the views of
    ``job["target"]``, draws seeded with ``SEED`` → (a record: per step the
    metrics and seconds, each parameter's sha256 after the steps, the launch
    counts, the norms per parameter group of the gradients each step handed
    to Adam and the peak memory; the reconstructor; its state)."""
    import hashlib

    import torch

    from gshell_tpu_torch.train.reconstruct import Reconstructor, _leaves, load_state
    from gshell_tpu_torch.train.setup import kernel_launches, reconstructor_from_flags
    from gshell_tpu_torch.utils.config import load_flags
    from gshell_tpu_torch.utils.rng import TorchDraws

    dev = torch.device(job["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    base = reconstructor_from_flags(load_flags(job["config"]), dev)
    rec = Reconstructor(base.geo, base.mat_cfg, base.flags, base.tcfg, spatial=tuple(job["spatial"]), group=group)
    state, _ = load_state(rec, job["state"])
    state.step = rec.tcfg.shadow_ramp_iters
    target = torch.load(job["target"], map_location=dev)
    draws = TorchDraws(torch.Generator(dev).manual_seed(SEED))
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    out = {"steps": [], "grad_norms": []}
    groups = {"geo": state.params_geo, "mat": state.params_mat, "light": [state.light_base]}
    for i in range(job["steps"]):
        t0 = time.time()
        m = rec.train_step(state, draws.child(f"step{i}"), target)
        sync()
        out["steps"].append({"s": time.time() - t0, **{k: float(v) for k, v in m.items()}})
        with torch.no_grad():  # the gradients the step handed to Adam, averaged across the ranks
            out["grad_norms"].append({g: float(torch.linalg.vector_norm(torch.cat(
                [p.grad.reshape(-1) for p in _leaves(tree)]))) for g, tree in groups.items()})
    out["launches"] = kernel_launches()
    out["peak_gib"] = _peak_gib(dev)
    out["sha256"] = [hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
                     for p in _leaves((state.params_geo, state.params_mat, [state.light_base]))]
    out["cells_per_rank"] = len(rec.spatial.cells())
    return out, rec, state


def diffusion_steps(job: dict, mesh) -> dict:
    """``job["small"]["steps"]`` steps of ``DiffusionTrainer(mesh=mesh)``
    (``None``: one process) on the grids matching ``job["glob"]``, the
    rank's rows from ``DistributedGridSampler``, draws seeded with ``SEED``
    → {"log": per step the metrics and seconds, "params", "peak_gib"}."""
    import glob

    import torch

    from gshell_tpu_torch.data.grids import GridSampler
    from gshell_tpu_torch.data.multihost import DistributedGridSampler
    from gshell_tpu_torch.models.unet3d import UNet3DConfig, n_params
    from gshell_tpu_torch.train.diffusion import DiffusionTrainConfig, DiffusionTrainer
    from gshell_tpu_torch.utils.rng import TorchDraws

    dev = torch.device(job["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    c = job["small"]
    tr = DiffusionTrainer(DiffusionTrainConfig(num_grad_acc_steps=c["grad_acc"]),
                          UNet3DConfig(base_channels=c["base_channels"], dropout=0.0), device=dev, mesh=mesh)
    state = tr.init_state(TorchDraws(torch.Generator(dev).manual_seed(SEED)).child("init"))
    files = sorted(glob.glob(job["glob"]))
    sampler = (GridSampler(files, c["grad_acc"], c["batch"], seed=SEED, device=dev) if mesh is None else
               DistributedGridSampler(files, c["grad_acc"], c["batch"], tr.rank, tr.world, seed=SEED, device=dev))
    log = []
    for it in range(c["steps"]):
        t0 = time.time()
        state, m = tr.train_step(state, TorchDraws(torch.Generator(dev).manual_seed(SEED + it)), sampler())
        sync()
        log.append({"s": time.time() - t0, **m})
    return {"log": log, "params": n_params(state.model), "peak_gib": _peak_gib(dev)}


def rank_worker(kind: str, rank: str, world: str, port: str, job_path: str, out_path: str) -> int:
    """One gloo rank of phase 13's two-rank runs on the card (``python3
    chip_smoke.py --rank-worker KIND RANK WORLD PORT JOB OUT``): "diffusion"
    runs :func:`diffusion_steps`, "banded" runs :func:`banded_steps`, over
    the group; writes the rank's record to OUT."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from gshell_tpu_torch.parallel.sharding import make_mesh
    from gshell_tpu_torch.utils import kernels

    with open(job_path) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
        kernels.build()
        kernels.lib()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=int(rank), world_size=int(world))
    try:
        if kind == "diffusion":
            rec = diffusion_steps(job, make_mesh(device_type=dev.type))
        else:
            rec = banded_steps(job, dist.group.WORLD)[0]
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def run_two_ranks(kind: str, job: dict, timeout: float = 420.0) -> list:
    """``kind`` on two gloo ranks sharing the card, each a :func:`rank_worker`
    subprocess → each rank's record; raises if a rank exits non-zero or
    outlives ``timeout`` (both are killed)."""
    job_path = os.path.join(DIST_OUT, f"{kind}_job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    outs = [os.path.join(DIST_OUT, f"{kind}_rank{r}.json") for r in range(2)]
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker", kind, str(r), "2", port,
                               job_path, outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.time() + timeout
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.time()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"phase 13: a {kind} rank outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"phase 13: {kind} rank {r} exited {p.returncode}:\n{log[-4000:]}")
    records = []
    for o in outs:
        with open(o) as f:
            records.append(json.load(f))
    return records


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def diffusion_dp(smi: str, dev) -> dict:
    """Phase 13 (a).  Returns its record and the failed checks."""
    import gc

    import numpy as np
    import torch

    from gshell_tpu_torch import main_diffusion

    bad = []
    full = ["--mode", "train", "--data-glob", os.path.join(DIFF_OUT, "baked", "*.npz"), "--mask-file",
            os.path.join(DIFF_OUT, "masks.npz"), "--batch", "1", "--grad-acc", "2", "--n-iters", "1",
            "--log-freq", "1", "--snapshot-freq", "1000", "--device", str(dev)]
    runs, det = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("no group", []), ("nccl", ["--multihost", "--coordinator", f"127.0.0.1:{_free_port()}",
                                                        "--num-processes", "1", "--process-id", "0"])):
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            out = main_diffusion.main(full + ["--workdir", os.path.join(DIST_OUT, "full_" + name.replace(" ", "_"))]
                                      + extra)
            runs[name] = {**out["log"][0], "peak_gib": _peak_gib(dev), "params": out["params"]}
    finally:
        torch.backends.cudnn.deterministic = det
    p, q = runs["no group"], runs["nccl"]
    equal = p["loss"] == q["loss"] and p["grad_norm"] == q["grad_norm"]
    print(f"diffusion full width ({p['params']} parameters, batch 1 x 2), deterministic cuDNN: without a group "
          f"loss {p['loss']!r} grad_norm {p['grad_norm']!r} in {p['s']:.3f} s, peak {p['peak_gib']:.2f} GiB; NCCL "
          f"world size 1 loss {q['loss']!r} grad_norm {q['grad_norm']!r} in {q['s']:.3f} s, peak "
          f"{q['peak_gib']:.2f} GiB; bit-equal {equal}  [{smi}]")
    if not equal:
        bad.append("NCCL at world size 1 differs from the step without a group")

    grids = os.path.join(DIST_OUT, "small_grids")
    os.makedirs(grids, exist_ok=True)
    rng = np.random.default_rng(SEED)
    d = DIST_SMALL["res"]
    for i in range(4):
        np.savez(os.path.join(grids, f"g{i}.npz"), grid=rng.normal(size=(d, d, d, 4)).astype(np.float32),
                 occgrid=rng.normal(size=(2 * d, 2 * d, 2 * d)).astype(np.float32))
    job = {"glob": os.path.join(grids, "*.npz"), "device": dev.type, "small": DIST_SMALL}
    t0 = time.time()
    ranks = run_two_ranks("diffusion", job)
    ranks_s = time.time() - t0
    one = diffusion_steps(job, None)
    one_peak = one["peak_gib"]
    a, b = (r["log"] for r in ranks)
    same = [(x["loss"], x["grad_norm"]) for x in a] == [(x["loss"], x["grad_norm"]) for x in b]
    rel = [max(_rel(x["loss"], y["loss"]), _rel(x["grad_norm"], y["grad_norm"])) for x, y in zip(a, one["log"])]
    print(f"diffusion 2 gloo ranks on one card ({ranks[0]['params']} parameters, base 32, grid {d}, batch 2 x 2, "
          f"1 row a rank): steps {[round(x['s'], 3) for x in a]} s, "
          f"peak {[round(r['peak_gib'], 2) for r in ranks]} GiB a rank "
          f"({ranks_s:.1f} s with the processes' start); 1 process: steps {[round(x['s'], 3) for x in one['log']]} "
          f"s, peak {one_peak:.2f} GiB; ranks equal {same}; loss / grad_norm against 1 process, max rel "
          f"{[f'{v:.2e}' for v in rel]}  [{smi}]")
    if not same:
        bad.append("the two diffusion ranks disagree")
    if not all(v <= DIST_RTOL for v in rel):
        bad.append(f"two diffusion ranks against one process: {rel}")
    return {"nccl_world_1": {"no_group": p, "nccl": q, "bit_equal": equal},
            "gloo_2_ranks": {"steps_s": [x["s"] for x in a],
                             "peak_gib": [r["peak_gib"] for r in ranks], "loss": [x["loss"] for x in a],
                             "one_process_loss": [x["loss"] for x in one["log"]], "max_rel": rel,
                             "ranks_equal": same, "one_process_peak_gib": one_peak}}, bad


def band_kernels(rec, state, mvp, band: int, held: dict, taps: dict, label: str, smi: str) -> dict:
    """The kernels at the cell shape: the first and last tapped launches
    held against their plain versions (errors into ``held``), stage B timed
    on band ``band`` of ``mvp``'s view of the state's mesh, the stencil on
    the first tapped (forward, C = 6) launch's normals and depths."""
    import torch

    from gshell_tpu_torch.ops import math as gm
    from gshell_tpu_torch.ops import rasterize as rz
    from gshell_tpu_torch.parallel.spatial import band_mvp

    nv, nb = rec.spatial.n_view, rec.spatial.n_band
    h, w = rec.flags.resolution
    hb2 = h // nb + 32
    for args, _ in taps["rasterize_stage_b"]:
        if args[3] != (hb2 // rz.TILE) * (w // rz.TILE):
            raise RuntimeError(f"{label}: a stage-B launch of {args[3]} tiles, not a {hb2}x{w} cell's")
    for args, _ in taps["bilateral_accumulate"]:
        if tuple(args[0].shape[:2]) != (hb2, w):
            raise RuntimeError(f"{label}: a stencil launch at {tuple(args[0].shape)}, not {hb2}x{w}")
    hold_taps(f"{label} {hb2}x{w} cell", taps, held)
    with torch.no_grad():
        mesh = rec.geo.get_mesh(state.params_geo)
        v_clip = gm.xfm_points(mesh.verts, band_mvp(mvp, band * (h // nb) - 16, hb2, h))
        bins = rz.bin_pairs(v_clip, mesh.faces, (hb2, w))
        sb = time_stage_b(bins, v_clip, mesh.faces, (hb2, w), f"{label} band {band}", smi)
        col, nrm, zdz = taps["bilateral_accumulate"][0][0][:3]
        st = time_stencil(col, nrm, zdz, smi)
    return {"shape": [hb2, w], "rasterize_stage_b": sb, "bilateral_accumulate": st}


def pixel_agreement(rec, state, target) -> dict:
    """Banded against unbanded renders of the state's mesh under the ``kd``
    BSDF (no Monte-Carlo walk), local mode, outside rows 0 and H - 1: per
    buffer the share of pixels within ``tol`` in every channel, for tol
    1e-4 (JAX's rule) and 1e-2; beside it the same shares of the unbanded
    render against itself with its MVP's y row one ulp off (``floor``): how
    far the rounding that ``band_mvp`` brings moves the buffers of this
    mesh by itself."""
    import torch

    from gshell_tpu_torch.parallel.spatial import CellGrid, render_batch_banded
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.render.render import render_mesh
    from gshell_tpu_torch.utils.rng import TorchDraws

    dev = state.light_base.device
    flags = rec.flags._replace(bsdf="kd")
    light = update_pdf(state.light_base.detach())
    n_views = target["mvp"].shape[0]
    with torch.no_grad():
        mesh = rec.geo.get_mesh(state.params_geo)

        def view(cd, mvp, campos, bg, res):
            return render_mesh(cd, mesh.verts, mesh.faces, mesh.v_nrm, mesh.msdf, state.params_mat, rec.mat_cfg,
                               mvp, campos, light, flags._replace(resolution=res), background=bg)

        def nudged(mvp):
            out = mvp.clone()
            out[1] = torch.nextafter(mvp[1], torch.full_like(mvp[1], math.inf))
            return out

        draws = TorchDraws(torch.Generator(dev).manual_seed(SEED))
        banded = render_batch_banded(view, draws, target["mvp"], target["campos"], target["background"],
                                     flags.resolution, CellGrid(rec.spatial.n_view, rec.spatial.n_band))
        plain, floor = ([view(draws.child(f"view{v}"), f(target["mvp"][v]), target["campos"][v],
                              target["background"][v], flags.resolution) for v in range(n_views)]
                        for f in (lambda m: m, nudged))
    out = {}
    for k in ("shaded", "mask", "msdf_image", "invdepth"):
        want = torch.stack([p[k] for p in plain])[:, 1:-1]
        for name, got in (("banded", banded[k][:, 1:-1]), ("floor", torch.stack([p[k] for p in floor])[:, 1:-1])):
            err = (got - want).abs().amax(-1)
            out[f"{k}_{name}"] = {f"{tol:g}": float((err <= tol).float().mean()) for tol in (1e-4, 1e-2)}
    return out


def agreement_failures(agree: dict) -> list:
    """The checks of :func:`pixel_agreement`'s shares that fail (see
    ``BAND_FLOOR_RATIO``)."""
    out = []
    for k in ("shaded", "mask", "msdf_image", "invdepth"):
        banded, floor = agree[f"{k}_banded"], agree[f"{k}_floor"]
        if banded["0.01"] < 0.99:
            out.append(f"{k}: {banded['0.01']:.6f} of the pixels within 1e-2")
        moved, moved_floor = 1.0 - banded["0.0001"], 1.0 - floor["0.0001"]
        if k in ("mask", "invdepth") and moved > 0.01:
            out.append(f"{k}: {moved:.6f} of the pixels off by more than 1e-4")
        if k in ("shaded", "msdf_image") and moved > max(0.01, BAND_FLOOR_RATIO * moved_floor):
            out.append(f"{k}: {moved:.6f} of the pixels off by more than 1e-4, over {BAND_FLOOR_RATIO} times "
                       f"the floor's {moved_floor:.6f}")
    return out


def distributed_path(smi: str, dev) -> dict:
    """Phase 13.  Returns the phase's record (with the launches per path and
    the held errors); raises on any failed check."""
    import shutil

    import torch

    t_phase = time.time()
    shutil.rmtree(DIST_OUT, ignore_errors=True)
    os.makedirs(DIST_OUT)
    print("distributed cuts: " + "; ".join(DIST_CUTS))
    rec_out = {"cuts": DIST_CUTS}
    rec_out["diffusion"], bad = diffusion_dp(smi, dev)

    held, launches = {}, {}
    tgt_512 = os.path.join(DIST_OUT, "target_512.pt")
    torch.save(flexi_target(dev, RES), tgt_512)
    tets_job = {"config": os.path.join(CLI_OUT, "skirt_smoke.json"), "state": os.path.join(CLI_OUT, "run", "state.pt"),
                "target": tgt_512, "spatial": list(BANDED_SPATIAL), "steps": 2, "device": str(dev)}
    flexi_job = {"config": os.path.join(FLEXI_OUT, "deepfashion_mc_80_smoke.json"),
                 "state": os.path.join(FLEXI_OUT, "run", "state.pt"), "target": os.path.join(DIST_OUT, "target_1024.pt"),
                 "spatial": list(FLEXI_SPATIAL), "steps": 1, "device": str(dev)}
    torch.save(flexi_target(dev, FLEXI_RES), flexi_job["target"])
    for name, job in (("banded_tets", tets_job), ("banded_flexi", flexi_job)):
        with KernelTaps() as taps:
            run, rec, state = banded_steps(job, None)
        n_cells = BANDED_SPATIAL if name == "banded_tets" else FLEXI_SPATIAL
        cells = n_cells[0] * n_cells[1]
        want = {"rasterize_stage_b": cells * job["steps"], "bilateral_accumulate": 2 * cells * job["steps"]}
        launches[name] = run["launches"]
        got = lambda c: {k: c[k] for k in want}
        target = torch.load(job["target"], map_location=dev)
        run["kernels"] = band_kernels(rec, state, target["mvp"][0], 1, held, taps.taps, name, smi)
        if name == "banded_tets":
            run["pixel_agreement"] = pixel_agreement(rec, state, target)
        for i, e in enumerate(run["steps"]):
            print(f"{name} step {i}: {cells} cells of {run['kernels']['shape'][0]}x{run['kernels']['shape'][1]} in "
                  f"1 process, total {e['total']:.6f} img {e['img_loss']:.6f} reg {e['reg_loss']:.6f} n_faces "
                  f"{int(e['n_faces'])} raster_dropped {int(e['raster_dropped'])} nonfinite_grads "
                  f"{int(e['nonfinite_grads'])} | {e['s']:.3f} s/step  [{smi}]")
        agree = ("" if "pixel_agreement" not in run else ", banded vs unbanded, share of pixels within 1e-4 / "
                 f"1e-2 (floor: unbanded, its MVP one ulp off) {json.dumps(run['pixel_agreement'])}")
        print(f"{name}: launches {json.dumps(run['launches'])} (want {json.dumps(want)}), peak "
              f"{run['peak_gib']:.2f} GiB{agree}  [{smi}]")
        bad += [f"{name} step {i}: {k} {e[k]}" for i, e in enumerate(run["steps"]) for k in ("total", "img_loss")
                if not _finite(e[k])]
        bad += [f"{name} step {i}: n_faces {e['n_faces']}, raster_dropped {e['raster_dropped']}"
                for i, e in enumerate(run["steps"]) if e["n_faces"] <= 0 or e["raster_dropped"] != 0]
        if got(run["launches"]) != want or run["launches"]["mc_shade"] <= 0:
            bad.append(f"{name}: launches {run['launches']}, want {want} and the MC shade's")
        if "pixel_agreement" in run:
            bad += [f"{name}: banded against unbanded, {e}" for e in agreement_failures(run["pixel_agreement"])]
        rec_out[name] = run
        del rec, state, taps
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if name == "banded_tets":
            t0 = time.time()
            ranks = run_two_ranks("banded", tets_job)
            two = {"seconds_with_start": time.time() - t0, "ranks": ranks}
            launches["banded_tets_2_ranks"] = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
            a, b = ranks
            differ = [i for i, (x, y) in enumerate(zip(a["sha256"], b["sha256"])) if x != y]
            rel = [_rel(x["total"], y["total"]) for x, y in zip(a["steps"], run["steps"])]  # held: the first
            rel_grad = {g: _rel(a["grad_norms"][0][g], v) for g, v in run["grad_norms"][0].items()}
            two.update(params_equal=not differ, max_rel_loss=rel, rel_grad_norms_step0=rel_grad)
            print(f"banded_tets on 2 gloo ranks ({a['cells_per_rank']} cells a rank): steps "
                  f"{[round(e['s'], 3) for e in a['steps']]} / {[round(e['s'], 3) for e in b['steps']]} s, peak "
                  f"{[round(r['peak_gib'], 2) for r in ranks]} GiB a rank ({two['seconds_with_start']:.1f} s with "
                  f"the processes' start); launches {json.dumps(launches['banded_tets_2_ranks'])}; the ranks' "
                  f"parameters bit-equal after the steps {not differ}; against 1 process: total loss rel "
                  f"{[f'{v:.2e}' for v in rel]}, step 0's gradient norms {json.dumps(a['grad_norms'][0])} against "
                  f"{json.dumps(run['grad_norms'][0])}, rel {json.dumps({g: f'{v:.2e}' for g, v in rel_grad.items()})}"
                  f"  [{smi}]")
            if differ:
                bad.append(f"the two banded ranks' parameters differ: {differ}")
            if not rel[0] <= DIST_RTOL:
                bad.append(f"two banded ranks against one process, loss: {rel}")
            if not all(v <= DIST_GRAD_RTOL for v in rel_grad.values()):
                bad.append(f"two banded ranks against one process, step 0's gradient norms: {rel_grad}")
            two_ranks = launches["banded_tets_2_ranks"]
            if got(two_ranks) != want or two_ranks["mc_shade"] != run["launches"]["mc_shade"]:
                bad.append(f"banded_tets_2_ranks: launches {two_ranks}, want {want} and one process's MC shade "
                           f"launches {run['launches']['mc_shade']}")
            rec_out["banded_tets_2_ranks"] = two
    rec_out["launches"], rec_out["held_max_abs_err"] = launches, held
    rec_out["seconds"] = time.time() - t_phase
    print(f"distributed phase: {rec_out['seconds']:.1f} s")
    if bad:
        raise RuntimeError("phase 13 (distributed paths) failed: " + "; ".join(bad))
    return rec_out


# Phase 14: the measurement entry points (the port's bench.py, bench_extract.py
# and tools/bench_diffusion.py), each ``main`` in process with its standard
# output captured: one JSON line each, with the JAX twin's metric string.
BENCH_ARGV = ["--one", f"{RES},{GRID},{SPP},{BATCH}"]
EXTRACT_ARGVS = (["64"], ["80"])  # FlexiCubes runs at min(RES, 80): 64, then 80
DIFFUSION_BENCH_ARGV = ["128", "1", "3"]


def _captured(fn, argv, counted=None) -> tuple:
    """(what ``fn(argv)`` returns, its one stdout line parsed); ``counted``
    (an ``EntryPoints``) runs it with the launch counts and taps."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = counted.counted(fn, argv) if counted is not None else fn(argv)
    lines = buf.getvalue().splitlines()
    if len(lines) != 1:
        raise RuntimeError(f"{fn.__module__} printed {len(lines)} lines on stdout, not one: {lines}")
    return out, json.loads(lines[0])


def bench_path(smi: str, dev, wp_steps: list) -> dict:
    """Phase 14: ``bench.main`` at the working point (state steps 0 to 21 from
    the pretrained state, against phase 6's steps at state step 1000,
    ``wp_steps``), counted and tapped as the CLI's entry points are, each
    timed step launching stage B ``BATCH`` times, the stencil ``2 *
    BATCH`` times and the gathers' backward, the first and last launches
    held; then ``bench_extract.main`` at 64 and 80 and
    ``bench_diffusion.main``, which launch neither the raster nor the
    stencil kernel.  Returns the phase's record; raises on any failed
    check."""
    import torch

    from gshell_tpu_torch import bench, bench_diffusion, bench_extract
    from gshell_tpu_torch.train.setup import kernel_launches

    t_phase = time.time()
    dv = ["--device", str(dev)]
    with KernelTaps() as taps:
        ep = EntryPoints(taps)
        run, line = _captured(bench.main, BENCH_ARGV + dv, ep)
        launches = {"bench": kernel_launches()}
        ep.hold("bench (warm-up step: first launch; the FLOP-counted step: last)", run)
    want = {"rasterize_stage_b": BATCH, "bilateral_accumulate": 2 * BATCH}
    bad = [f"bench timed step {i + 1}: launches {c}, want {want}, the gathers' backward and the MC shade"
           for i, c in enumerate(run["step_launches"])
           if {k: c[k] for k in want} != want or c["gather_rows"] <= 0 or c["mc_shade"] <= 0]
    metric = f"gshell_train_step_iters_per_sec(res{RES},grid{GRID},spp{SPP},b{BATCH})"
    if line["metric"] != metric or not (_finite(line["value"]) and line["value"] > 0):
        bad.append(f"bench line {line}")
    print(f"bench line: {json.dumps(line)}  [{smi}]")
    print(f"bench at state steps 1-20: {1.0 / line['value']:.3f} s/step against phase 6's "
          f"{[round(x, 3) for x in wp_steps]} s at state step 1000; warm-up (state step 0) "
          f"{line['compile_sec']:.3f} s; peak {run['peak_gib']} GiB; loss {run['loss']:.5f}; launches by phase "
          f"{json.dumps(run['launches'])}  [{smi}]")

    c0 = kernel_launches()
    extraction = {}
    for argv in EXTRACT_ARGVS:
        torch.cuda.empty_cache()
        t0 = time.time()
        ext, ext_line = _captured(bench_extract.main, argv + dv)
        ext["seconds"] = time.time() - t0
        print(f"bench_extract {argv[0]} line: {json.dumps(ext_line)}; FlexiCubes res {ext['flexicubes_res']} "
              f"{ext['flexicubes_ms']:.3f} ms, pbr_bsdf [8,512,512] fwd {ext['pbr_bsdf_fwd_ms']:.3f} ms bwd "
              f"{ext['pbr_bsdf_bwd_ms']:.3f} ms; {ext['seconds']:.1f} s  [{smi}]")
        if ext_line["metric"] != f"gshell_tet_extraction_ms(res{argv[0]})" or not ext_line["value"] > 0:
            bad.append(f"bench_extract line {ext_line}")
        extraction[argv[0]] = ext

    torch.cuda.empty_cache()
    t0 = time.time()
    _, diff_line = _captured(bench_diffusion.main, DIFFUSION_BENCH_ARGV + dv)
    diff_s = time.time() - t0
    d = int(DIFFUSION_BENCH_ARGV[0])
    print(f"bench_diffusion line: {json.dumps(diff_line)}; {diff_s:.1f} s  [{smi}]")
    if diff_line["metric"] != f"gmeshdiffusion_train_step(grid{d},occ{2 * d},b{DIFFUSION_BENCH_ARGV[1]})" \
            or not diff_line["value"] > 0:
        bad.append(f"bench_diffusion line {diff_line}")
    if any(kernel_launches()[k] != c0[k] for k in (*want, "mc_shade")):
        bad.append(f"bench_extract / bench_diffusion launched a hand kernel: {c0} -> {kernel_launches()}")

    rec_out = {"train_step": line, "extraction": extraction, "diffusion": diff_line,
               "phase6_steps_s_at_step_1000": wp_steps, "bench_peak_gib": run["peak_gib"],
               "bench_launches_by_phase": run["launches"], "bench_seconds": run["seconds"],
               "launches": launches, "held_max_abs_err": ep.held}
    rec_out["seconds"] = time.time() - t_phase
    print(f"bench phase: {rec_out['seconds']:.1f} s")
    if set(ep.held) != KERNELS_HELD:
        bad.append(f"held only {sorted(ep.held)} against the plain versions")
    if bad:
        raise RuntimeError("phase 14 (measurement entry points) failed: " + "; ".join(bad))
    return rec_out


def unlaunched(launches: dict) -> list:
    """The paths (name → kernel → launches) on which a kernel that should run
    there did not: the raster, the stencil and the MC shade on every path
    (each renders and shades), the gathers' backward on the paths that
    train (not a ground-truth render, not an eval)."""
    def due(path: str, kernel: str) -> bool:
        return kernel != "gather_rows" or (path.endswith(("train", "train_resumed")) and "gt" not in path)
    return [f"{path}: {k} not launched" for path, c in launches.items() for k, v in c.items()
            if v <= 0 and due(path, k)]


def absorb_path(results: list, by_path: dict, launches: dict, held: dict) -> None:
    """Add a phase's launches per path to ``by_path`` and its held errors to
    each kernel's line (``max_abs_err``, ``launches_by_path``,
    ``launches``); raises if a kernel was not launched on every path."""
    by_path.update(launches)
    for r in results:
        name = r["name"]
        r["max_abs_err"] = max(r["max_abs_err"], held[name])
        r["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if min(r["launches_by_path"].values()) == 0:
            raise RuntimeError(f"{name} was not launched on every path: {r['launches_by_path']}")


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device found (torch.cuda.is_available() is False); "
              "this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gshell_tpu_torch.ops import denoiser as dn
    from gshell_tpu_torch.ops import math as gm
    from gshell_tpu_torch.ops import rasterize as rz
    from gshell_tpu_torch.train.setup import kernel_launches
    from gshell_tpu_torch.utils import kernels
    from gshell_tpu_torch.utils.synthetic import crowded_tile_mesh

    dev = torch.device("cuda:0")
    smi = card_name()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {smi}")

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.time()
    kernels.build(verbose=True)
    kernels.lib()
    print(f"build: {time.time() - t0:.2f} s (nvcc {kernels.build_seconds:.2f} s)")

    # ---- set up the slice -------------------------------------------------
    rec, state, draws, target = working_point(dev)
    geo = rec.geo
    results = []

    # ---- phase 3: stage B kernel vs plain on the real mesh -------------------
    def check_stage_b(label, bins):
        return hold_stage_b(label, (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n))

    with torch.no_grad():
        mesh, faces_c, fvalid_c, n_faces, v_nrm, _ = geo.extract(state.params_geo)
        print(f"pretrained mesh: {int(n_faces)} faces")
        if int(n_faces) == 0:
            raise RuntimeError("the pretrained SDF has no surface (n_faces == 0)")
        max_err = 0.0
        for b in range(BATCH):
            v_clip = gm.xfm_points(mesh.verts, target["mvp"][b])
            bins = rz.bin_pairs(v_clip, faces_c, (RES, RES))
            max_err = max(max_err, check_stage_b(f"view {b}", bins))
        v_crowd, f_crowd = crowded_tile_mesh(RES)
        crowd = rz.bin_pairs(v_crowd.to(dev), f_crowd.to(dev), (RES, RES))
        max_err = max(max_err, check_stage_b("crowded tile, ties, +-0.0", crowd))
        sb = time_stage_b(bins, v_clip, faces_c, RES, f"view {BATCH - 1}", smi)
    results.append({"name": "rasterize_stage_b", "route": "cuda",
                    "source": "gshell_tpu_torch/csrc/rasterize_stage_b.cu",
                    "replaces": "gshell_tpu/ops/rasterize.py:301", "max_abs_err": max_err,
                    "ms": sb["ms"], "plain_ms": sb["plain_ms"], "bound_ms": sb["bound_ms"],
                    "bound_by": sb["bound_by"], "library_ms": None, "eager_ms": sb["eager_ms"],
                    "cuda_kernels_per_launch": 3, "pair_px_box": sb["pair_px_box"],
                    "pair_px_inside": sb["pair_px_inside"]})

    # ---- phase 4: denoiser kernel vs plain on a real rendered view -------------
    with torch.no_grad():
        bufs = probe_view(rec, state, draws, target, mesh, faces_c, v_nrm)
        nrm = bufs["normal"][..., 0:3].contiguous()
        zdz = bufs["z_grad"][..., 0:2].contiguous()
        cols = {3: bufs["diffuse_light"][..., 0:3].contiguous(),
                6: torch.cat([bufs["diffuse_light"][..., 0:3], bufs["specular_light"][..., 0:3]], -1)
                .contiguous()}
        errs, times = [], {}
        for c, col in cols.items():
            for from_tap in (False, True):
                kc, kw = dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
                pc, pw = dn.bilateral_plain(col, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
                for k, p in ((kc, pc), (kw, pw)):
                    err = (k - p).abs()
                    bad = int((err > 1e-6 + 1e-5 * p.abs()).sum())
                    errs.append(float(err.max()))
                    print(f"denoiser C={c} denom_from_tap={from_tap}: max |err| {float(err.max()):.3e}, "
                          f"{bad} outside rtol 1e-5 / atol 1e-6")
                    if bad:
                        raise RuntimeError("bilateral kernel disagrees with the plain version")
            times[c] = time_stencil(col, nrm, zdz, smi)
    st6, st3 = times[6], times[3]
    results.append({"name": "bilateral_accumulate", "route": "cuda",
                    "source": "gshell_tpu_torch/csrc/bilateral.cu",
                    "replaces": "gshell_tpu/ops/denoiser.py:89", "max_abs_err": max(errs),
                    "ms": st6["ms"], "plain_ms": st6["plain_ms"], "bound_ms": st6["bound_ms"],
                    "bound_by": st6["bound_by"], "library_ms": None, "eager_ms": st6["eager_ms"], "channels": 6,
                    "ms_c3": st3["ms"], "eager_ms_c3": st3["eager_ms"], "plain_ms_c3": st3["plain_ms"],
                    "bound_ms_c3": st3["bound_ms"]})

    gather_bwd = gather_backward_check(smi)
    mc_shade = mc_shade_check(smi)
    tc, fc = mc_shade["cells"]
    results.append({"name": "mc_shade", "route": "cuda", "source": "gshell_tpu_torch/csrc/mc_shade.cu",
                    "replaces": "none (the port's eager walk, gshell_tpu_torch/ops/shade.py _MCAccumulate)",
                    "max_abs_err": max(max(c["errors"].values()) for c in mc_shade["cells"]),
                    "error": "relative norm of the forward and of each input's cotangent",
                    "ms": tc["fwd_ms"], "bwd_ms": tc["bwd_ms"], "bound_ms": tc["fwd_bound_ms"],
                    "bound_by": tc["fwd_bound_by"], "bwd_bound_ms": tc["bwd_bound_ms"], "library_ms": None,
                    "eager_ms": tc["held_plain_ms"], "plain_ms": tc["held_plain_ms"],
                    **{f"{k}_flexi80": fc[k] for k in ("fwd_ms", "bwd_ms", "fwd_bound_ms", "bwd_bound_ms")}})

    # ---- phase 5: a small step on the card vs the CPU plain path -------------
    _small_step_reference(dev)

    # ---- phase 6: the slice ---------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    wp_steps = []
    for i in range(N_STEPS):
        sb0, bl0 = rz.stage_b_calls, dn.bilateral_launches
        t0 = time.time()
        m = rec.train_step(state, draws.child(f"step{i}"), target)
        torch.cuda.synchronize()
        dt = time.time() - t0
        wp_steps.append(dt)
        m = {k: float(v) for k, v in m.items()}
        sb, bl = rz.stage_b_calls - sb0, dn.bilateral_launches - bl0
        print(f"step {i}: total {m['total']:.6f} img {m['img_loss']:.6f} reg {m['reg_loss']:.6f} "
              f"nonfinite_grads {int(m['nonfinite_grads'])} sdf_net |grad| {m['sdf_net_grad_norm']:.4e} "
              f"n_faces {int(m['n_faces'])} "
              f"px_dropped {int(m['px_dropped'])} raster_dropped {int(m['raster_dropped'])} "
              f"launches stage_b {sb} (3 CUDA kernels each) bilateral {bl} | {dt:.3f} s/step, "
              f"max_mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{smi}]")
        for k in ("total", "img_loss", "reg_loss"):
            if not math.isfinite(m[k]):
                raise RuntimeError(f"step {i}: {k} is not finite")
        if m["n_faces"] <= 0 or m["raster_dropped"] != 0:
            raise RuntimeError(f"step {i}: n_faces {m['n_faces']}, raster_dropped {m['raster_dropped']}")
        if sb != BATCH or bl != 2 * BATCH:
            raise RuntimeError(f"step {i}: launches stage_b {sb} (want {BATCH}), "
                               f"bilateral {bl} (want {2 * BATCH})")
    by_path = {"train_step": kernel_launches()}
    if by_path["train_step"]["mc_shade"] <= 0:
        raise RuntimeError(f"phase 6 launched no MC shade kernel: {by_path['train_step']}")

    # ---- phase 7: the command-line path at full width --------------------------
    del rec, state, draws, target, geo, mesh, faces_c, fvalid_c, v_nrm, bufs, bins, crowd
    torch.cuda.empty_cache()
    absorb_path(results, by_path, *cli_path(smi))

    # ---- phase 8: the diffusion path at full width (launches neither kernel) ----
    torch.cuda.empty_cache()
    diffusion = diffusion_path(smi, dev)

    # ---- phase 9: FlexiCubes at the full width of deepfashion_mc_80 -------------
    torch.cuda.empty_cache()
    flexi = flexi_path(smi, dev)
    absorb_path(results, by_path, flexi["launches"], flexi.pop("held_max_abs_err"))
    for r in results:
        if r["name"] not in flexi["kernels_1024"]:
            continue
        k = flexi["kernels_1024"][r["name"]]
        r.update({"ms_1024": k["ms"], "eager_ms_1024": k["eager_ms"], "plain_ms_1024": k["plain_ms"],
                  "bound_ms_1024": k["bound_ms"], "bound_by_1024": k["bound_by"]})

    # ---- phase 10: the second surface layer at the skirt config's full width --
    torch.cuda.empty_cache()
    second = second_layer_path(smi, dev)
    absorb_path(results, by_path, second["launches"], second.pop("held_max_abs_err"))

    # ---- phase 11: textured meshes — spp 2, modulated denoise, the UV bake ---
    torch.cuda.empty_cache()
    textured = textured_path(smi, dev)
    absorb_path(results, by_path, textured["launches"], textured.pop("held_max_abs_err"))

    # ---- phase 12: the other fields and shadow sources ---------------------------
    torch.cuda.empty_cache()
    fields = fields_path(smi, dev, flexi)
    absorb_path(results, by_path, fields["launches"], fields.pop("held_max_abs_err"))

    # ---- phase 13: the distributed paths -------------------------------------
    torch.cuda.empty_cache()
    distributed = distributed_path(smi, dev)
    absorb_path(results, by_path, distributed["launches"], distributed.pop("held_max_abs_err"))
    for r in results:
        for name in ("banded_tets", "banded_flexi"):
            k = distributed[name]["kernels"]
            if r["name"] not in k:
                continue
            tag = "{}x{}".format(*k["shape"])
            r.update({f"{key}_{tag}": k[r["name"]][key] for key in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                                     "bound_by")})

    # ---- phase 14: the measurement entry points ---------------------------------
    torch.cuda.empty_cache()
    benches = bench_path(smi, dev, wp_steps)
    absorb_path(results, by_path, benches.pop("launches"), benches.pop("held_max_abs_err"))

    print(json.dumps({"diffusion": diffusion}))
    print(json.dumps({"flexicubes": flexi}))
    print(json.dumps({"second_layer": second}))
    print(json.dumps({"textured": textured}))
    print(json.dumps({"fields": fields}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"bench": benches}))
    print(json.dumps({"kernels": results}))
    print(json.dumps({"gather_backward": gather_bwd}))
    print(json.dumps({"mc_shade": mc_shade}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(*sys.argv[2:]))
    sys.exit(main())
