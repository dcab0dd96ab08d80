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
  5. a small train step (tet grid 16, 64x64) on the card against the same
     step on the CPU, where both kernels take their plain versions: same
     state, same draws; loss to rtol 1e-3, gradient cosines >= 0.98;
  6. the slice: Reconstructor at the working point (512², tet grid 64,
     n_samples 8, batch 2, MLP SDF + eikonal 16384, mesh-splat shadows,
     shade_budget 0.5, denoiser on, default hash grid), 1000 SDF pretrain
     steps, state step 1000 (shadows and sigma = 2 live), five train steps on
     a synthetic disk target; losses finite, faces > 0, no raster drops, and
     exactly 2 stage-B launches (three CUDA kernels each: schedule, test,
     unpack) and 4 denoiser launches per step.

Prints a JSON line of per-kernel results (with ``bound_ms``, the least time
the card could take for the same work, see ``_bound_ms``), the nvidia-smi
line, and last
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit, no
ok line).  Usage: ``python3 chip_smoke.py`` from the repository root.
"""
import json
import math
import os
import subprocess
import sys
import time

RES, GRID, SPP, BATCH = 512, 64, 8, 2
N_STEPS = 5
SEED = 0


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


def stage_b_pair_pixels(bins, v_clip, faces, res: int):
    """What stage B must test on this view: (pixels of each pair's triangle
    bounding box within its tile, those of them inside all three edges),
    summed over the pairs."""
    import torch

    from gshell_tpu_torch.ops import rasterize as rz

    sx, sy = rz._tri_screen(v_clip, faces, res, res)[:2]
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
    JAX package's bench.py settings, its state after 1000 SDF pretrain steps
    at step ``shadow_ramp_iters`` (shadows and denoiser sigma 2 live), the
    draw source, and bench.py's synthetic disk target at batch BATCH."""
    import torch

    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.ops import math as gm
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max
    from gshell_tpu_torch.render.render import RenderFlags
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
    from gshell_tpu_torch.utils.rng import TorchDraws

    gcfg = GeometryConfig(grid_res=GRID, n_eikonal_samples=16384, total_iters=5000)
    geo = GShellGeometry(gcfg, dev)
    mat_cfg = MLPTexture3DConfig(channels=6, hash=HashGridConfig(), min_max=default_kd_ks_min_max())
    flags = RenderFlags(resolution=(RES, RES), n_samples=SPP, shade_budget=0.5,
                        jitter_tap_frac=0.25, mc_block=8, light_bf16=True, use_denoiser=True)
    tcfg = TrainConfig(batch=BATCH, use_shadows=True)
    rec = Reconstructor(geo, mat_cfg, flags, tcfg)
    draws = TorchDraws(torch.Generator(dev).manual_seed(seed))
    t0 = time.time()
    state = rec.init_state(draws.child("init"), pretrain_steps=1000)
    torch.cuda.synchronize()
    print(f"init_state (1000 pretrain steps): {time.time() - t0:.2f} s")
    state.step = tcfg.shadow_ramp_iters

    proj = gm.perspective(math.radians(45.0), 1.0, 0.1, 1000.0, device=dev)
    view = gm.lookat(torch.tensor([0.0, 0.0, 2.5], device=dev), torch.zeros(3, device=dev),
                     torch.tensor([0.0, 1.0, 0.0], device=dev))
    ys, xs = torch.meshgrid(torch.arange(RES, device=dev), torch.arange(RES, device=dev), indexing="ij")
    disk = (torch.sqrt((xs - RES / 2) ** 2 + (ys - RES / 2) ** 2) < 0.3 * RES).float()
    mask = disk[None, ..., None].repeat(BATCH, 1, 1, 1)
    target = {
        "mvp": (proj @ view)[None].repeat(BATCH, 1, 1),
        "campos": torch.tensor([[0.0, 0.0, 2.5]], device=dev).repeat(BATCH, 1),
        "img": torch.cat([torch.ones((BATCH, RES, RES, 3), device=dev) * 0.5 * mask, mask], -1),
        "background": torch.zeros((BATCH, RES, RES, 3), device=dev),
    }
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
        args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
        kz, kid = rz.rasterize_stage_b(*args)
        pz, pid = rz.stage_b_plain(*args)
        n_diff = int((kid != pid).sum())
        hit = pid >= 0
        z_diff = int((kz[hit] != pz[hit]).sum())
        cnt = bins.tile_cnt.float()
        n_subs = rz.stage_b_schedule(bins.tile_start, bins.tile_cnt).shape[0]
        print(f"stage B {label}: {int(bins.tile_cnt.sum())} pairs, pairs per tile max "
              f"{int(cnt.max())} mean {float(cnt.mean()):.2f} p99 {float(torch.quantile(cnt, 0.99)):.1f}, "
              f"{n_subs} sub-segments; {int(hit.sum())} px hit, {n_diff} ids differ, {z_diff} hit z differ")
        if n_diff or z_diff:
            raise RuntimeError(f"stage-B kernel disagrees with the plain version ({label})")
        return float((kz[hit] - pz[hit]).abs().max()) if hit.any() else 0.0

    with torch.no_grad():
        mesh, faces_c, fvalid_c, n_faces, v_nrm = geo.extract(state.params_geo)
        print(f"pretrained mesh: {int(n_faces)} faces")
        if int(n_faces) == 0:
            raise RuntimeError("the pretrained SDF has no surface (n_faces == 0)")
        max_err = 0.0
        for b in range(BATCH):
            v_clip = gm.xfm_points(mesh.verts, target["mvp"][b])
            bins = rz.bin_pairs(v_clip, faces_c, (RES, RES))
            max_err = max(max_err, check_stage_b(f"view {b}", bins))
        args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
        n_pairs = int(bins.tile_cnt.sum())
        box_px, inside_px = stage_b_pair_pixels(bins, v_clip, faces_c, RES)
        v_crowd, f_crowd = crowded_tile_mesh(RES)
        crowd = rz.bin_pairs(v_crowd.to(dev), f_crowd.to(dev), (RES, RES))
        max_err = max(max_err, check_stage_b("crowded tile, ties, +-0.0", crowd))
        k_ms = _device_ms(lambda: rz.rasterize_stage_b(*args))
        e_ms = _median_ms(lambda: rz.rasterize_stage_b(*args))
        p_ms = _median_ms(lambda: rz.stage_b_plain(*args))
        bound, bound_by = stage_b_bound(n_pairs, bins.n_tiles, box_px, inside_px)
    print(f"stage B at {RES}² (view {BATCH - 1}): {n_pairs} pairs, {n_pairs * 256} pair-pixels, "
          f"{box_px} in the triangles' boxes, {inside_px} inside all three edges; kernel {k_ms:.4f} ms "
          f"on the card ({e_ms:.4f} ms called from Python), plain {p_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({bound_by})  [{smi}]")
    results.append({"name": "rasterize_stage_b", "route": "cuda",
                    "source": "gshell_tpu_torch/csrc/rasterize_stage_b.cu",
                    "replaces": "gshell_tpu/ops/rasterize.py:301", "max_abs_err": max_err,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": None, "eager_ms": e_ms, "cuda_kernels_per_launch": 3,
                    "pair_px_box": box_px, "pair_px_inside": inside_px})

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
            times[c] = (_device_ms(lambda: dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11), k=5),
                        _median_ms(lambda: dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11)),
                        _median_ms(lambda: dn.bilateral_plain(col, nrm, zdz, 2.0, 11)),
                        stencil_bound(RES, RES, 11, c))
            k_ms, e_ms, p_ms, (bound, bound_by) = times[c]
            print(f"denoiser at {RES}², r=11, C={c}: kernel {k_ms:.4f} ms on the card "
                  f"({e_ms:.4f} ms called from Python), plain {p_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({bound_by})  [{smi}]")
    (k_ms, e_ms, p_ms, (bound, bound_by)), (k3_ms, e3_ms, p3_ms, (bound3, _)) = times[6], times[3]
    results.append({"name": "bilateral_accumulate", "route": "cuda",
                    "source": "gshell_tpu_torch/csrc/bilateral.cu",
                    "replaces": "gshell_tpu/ops/denoiser.py:89", "max_abs_err": max(errs),
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": None, "eager_ms": e_ms, "channels": 6,
                    "ms_c3": k3_ms, "eager_ms_c3": e3_ms, "plain_ms_c3": p3_ms, "bound_ms_c3": bound3})

    # ---- phase 5: a small step on the card vs the CPU plain path -------------
    _small_step_reference(dev)

    # ---- phase 6: the slice ---------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rz.stage_b_calls = 0
    dn.bilateral_launches = 0
    for i in range(N_STEPS):
        sb0, bl0 = rz.stage_b_calls, dn.bilateral_launches
        t0 = time.time()
        m = rec.train_step(state, draws.child(f"step{i}"), target)
        torch.cuda.synchronize()
        dt = time.time() - t0
        m = {k: float(v) for k, v in m.items()}
        sb, bl = rz.stage_b_calls - sb0, dn.bilateral_launches - bl0
        print(f"step {i}: total {m['total']:.6f} img {m['img_loss']:.6f} reg {m['reg_loss']:.6f} "
              f"nonfinite_grads {int(m['nonfinite_grads'])} n_faces {int(m['n_faces'])} "
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
    launches = {"rasterize_stage_b": rz.stage_b_calls, "bilateral_accumulate": dn.bilateral_launches}
    for r in results:
        r["launches"] = launches[r["name"]]
        if r["launches"] == 0:
            raise RuntimeError(f"{r['name']} was not launched by the train step")

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
