#!/usr/bin/env python3
"""Where the time and the non-finite gradients of the PyTorch port's train
step come from, on one CUDA GPU.

Builds the slice at ``chip_smoke.py``'s working point (512², tet grid 64,
n_samples 8, batch 2, state step 1000), or with ``--flexicubes`` the
FlexiCubes step at the full width of ``configs/deepfashion_mc_80.json``
(``chip_smoke.flexi_point``: voxel 80, 1024², n_samples 24, batch 2, state
step 1000, a disk target), and prints, each as a JSON line:

  1. ``first_step``: ``chip_smoke.py``'s first train step (the same draws),
     with its non-finite gradient elements per parameter group and per
     stage: the watched functions count the non-finite elements of the
     gradient that reaches their outputs (``name -> outK``) and that leaves
     through their tensor arguments (``name <- argK``); stages with a count
     above 0 are listed.  The stage where an argument's count is above 0
     while its outputs' are 0 is where the non-finite values are born.
  2. ``steady_steps``: host-clock seconds of five steps after three
     warm-up steps, each step ended by ``torch.cuda.synchronize()``.
  3. ``profile``: one step under ``torch.profiler``: the summed device time
     of the CUDA kernels, their launch count, and the twelve kernels with the
     most device time.  ``busy_share_estimate`` divides the kernel time by the
     host-clock wall time of the profiled step: the profiler slows the host,
     so it understates the busy share of an unprofiled step.
  4. ``layers``: host-clock milliseconds of a forward pass with
     ``torch.cuda.synchronize()`` around each layer (which removes the
     overlap between layers, so the layers add up to more than a plain
     step), then of the backward and of the three Adam steps; the second of
     two repetitions.

Usage: ``python3 tools/torch_step_profile.py [--flexicubes]`` from the
repository root.
"""
import argparse
import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gshell_tpu_torch.geometry import geometry as G  # noqa: E402
from gshell_tpu_torch.ops import bsdf as B  # noqa: E402
from gshell_tpu_torch.ops import shade as S  # noqa: E402
from gshell_tpu_torch.render import render as R  # noqa: E402
from gshell_tpu_torch.render.light import update_pdf  # noqa: E402

def emit(key, value):
    print(json.dumps({key: value}), flush=True)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def nonfinite_watch(counts):
    """Wrap ``fn`` so the non-finite gradient elements through it are counted
    into ``counts`` under ``name``."""
    def counter(key):
        def hook(g):
            counts[key] += int((~torch.isfinite(g)).sum())
        return hook

    def wrap(name, fn):
        def wrapped(*args, **kw):
            args = [a.view_as(a) if isinstance(a, torch.Tensor) and a.requires_grad else a for a in args]
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor) and a.requires_grad:
                    counts[f"{name} <- arg{i}"] += 0
                    a.register_hook(counter(f"{name} <- arg{i}"))
            out = fn(*args, **kw)
            for i, o in enumerate(_tensors(out)):
                if o.requires_grad:
                    counts[f"{name} -> out{i}"] += 0
                    o.register_hook(counter(f"{name} -> out{i}"))
            return out
        return wrapped
    return wrap


def patch(targets, wrap):
    """Replace each ``(module, name)`` by ``wrap(label, original)``; returns
    the originals."""
    saved = []
    for mod, name in targets:
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrap(f"{getattr(mod, '__name__', type(mod).__name__).split('.')[-1]}.{name}",
                                getattr(mod, name)))
    return saved


def restore(saved):
    for mod, name, fn in saved:
        setattr(mod, name, fn)


def grads_by_group(state):
    pg, pm = state.params_geo, state.params_mat
    out = {
        "deform": [pg["deform"]], "msdf": [pg["msdf"]],
        "sdf_net": [p for v in pg["sdf_net"].values() for p in v],
        "tables": [pm["tables"]], "mlp": list(pm["mlp"]), "light": [state.light_base],
    }
    if "cube_weights" in pg:
        out["cube_weights"] = [pg["cube_weights"]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--flexicubes", action="store_true",
                   help="the FlexiCubes step of configs/deepfashion_mc_80.json, not the working point")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device found", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = chip_smoke.card_name()
    emit("card", card)
    rec, state, draws, target = (chip_smoke.flexi_point if args.flexicubes else chip_smoke.working_point)(dev)
    geo, flags = rec.geo, rec.flags
    emit("workload", {"flexicubes": args.flexicubes, "resolution": list(flags.resolution),
                      "n_samples": flags.n_samples, "batch": int(target["mvp"].shape[0]),
                      "grid_res": geo.cfg.grid_res})

    # ---- 1. the first step's non-finite gradients ------------------------
    # chip_smoke.py's first train step: the same draws follow its probe render
    with torch.no_grad():
        mesh = geo.get_mesh(state.params_geo)
        chip_smoke.probe_view(rec, state, draws, target, mesh, mesh.faces, mesh.v_nrm)
    counts = collections.Counter()
    stages = [(G, "render_mesh"), (G, "make_shadow_field"), (geo, "extract"),
              (R, "interpolate"), (R, "bary_screen_derivs"), (R, "sample_mlp_texture"),
              (R, "env_shade"), (R, "bilateral_denoiser"), (R, "antialias"),
              (B, "prepare_shading_normal"), (S, "bsdf_sample"), (S, "bsdf_pdf"),
              (S, "ggx_sample"), (S, "_sample_ggx_vndf"), (S, "pbr_specular"), (S, "lambert")]
    saved = patch(stages, nonfinite_watch(counts))
    per_group = collections.Counter()
    handles = [p.register_hook(lambda g, k=k: per_group.update({k: int((~torch.isfinite(g)).sum())}))
               for k, ps in grads_by_group(state).items() for p in ps]
    m = rec.train_step(state, draws.child("step0"), target)
    torch.cuda.synchronize()
    restore(saved)
    for h in handles:
        h.remove()
    emit("first_step", {"nonfinite_grads": int(m["nonfinite_grads"]),
                        "nonfinite_per_group": {k: per_group[k] for k in grads_by_group(state)},
                        "nonfinite_per_stage": {k: v for k, v in sorted(counts.items()) if v},
                        "stages_watched": len(counts), "card": card})

    # ---- 2. steady steps ---------------------------------------------------
    for i in range(3):
        rec.train_step(state, draws.child(f"warm{i}"), target)
    torch.cuda.synchronize()
    secs = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.train_step(state, draws.child(f"step{i}"), target)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    emit("steady_steps", {"seconds": secs, "median": sorted(secs)[2],
                          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "card": card})

    # ---- 3. one profiled step ----------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.train_step(state, draws.child("profiled"), target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    emit("profile", {
        "wall_ms_profiled": wall_ms, "kernel_ms": dev_ms, "kernel_launches": sum(e.count for e in kern),
        "busy_share_estimate": dev_ms / wall_ms,
        "top_kernels": [{"ms": e.self_device_time_total / 1e3, "count": e.count, "name": e.key[:120]}
                        for e in top],
        "card": card,
    })

    # ---- 4. per-layer times ------------------------------------------------
    layer = collections.defaultdict(float)

    def timed(name, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            layer[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapped

    names = {"extract": (geo, "extract"), "fields (SDF MLP)": (geo, "fields"),
             "shadow occluder splat": (geo, "splat_occupancy"),
             "shadow field sweep": (G, "make_shadow_field"), "raster A+B+stitch": (R, "rasterize_tiled"),
             "interpolate": (R, "interpolate"), "material": (R, "sample_mlp_texture"),
             "MC shade forward": (R, "env_shade"), "denoiser forward": (R, "bilateral_denoiser"),
             "antialias": (R, "antialias"), "render_mesh": (G, "render_mesh")}
    saved = []
    for label, (mod, name) in names.items():
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timed(label, getattr(mod, name)))
    for rep in range(2):
        layer.clear()
        light = update_pdf(state.light_base)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, depth, reg, _ = geo.tick(
            draws.child(f"layers{rep}"), state.params_geo, state.params_mat, rec.mat_cfg, light, target,
            state.step, flags, rec.image_loss_fn, use_shadows=True, shadow_scale=1.0, denoiser_sigma=2.0)
        torch.cuda.synchronize()
        layer["forward (tick)"] = (time.perf_counter() - t0) * 1e3
        for opt in state.optimizers:
            opt.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        (img + depth + reg).backward()
        torch.cuda.synchronize()
        layer["backward"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for opt in state.optimizers:
            opt.step()
        torch.cuda.synchronize()
        layer["Adam x3"] = (time.perf_counter() - t0) * 1e3
    restore(saved)
    emit("layers", {"ms": dict(layer), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
