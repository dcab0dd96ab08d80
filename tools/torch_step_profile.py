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
     so it understates the busy share of an unprofiled step.  Then
     ``spans``: for each of the port's spans (``utils/spans.py``) that the
     step recorded, its count, host ms, self ms (less the part its child
     spans cover), and the device ms and count of the kernels launched
     while the host was inside it.

With ``--config FILE`` it builds instead the train step of that config at
its full width (``train.setup.reconstructor_from_flags``: its grid,
resolution, n_samples, batch; the config's SDF pretrain; state step 1000)
on two views of the port's synthetic skirt rendered as ground truth, and
prints ``first_step`` as above, then for each mode of ``--modes``
(``view_batch_mode``, default ``map_remat,map``), each from a copy of the
same state with draws of the same seed, a ``mode`` line: for one tick the
bytes its forward keeps for the backward and the forward's and the
backward's peaks above what was allocated before it; then host-clock
seconds of three steps after one warm-up step and the peak device memory
of those four steps (``"fits": false`` where the card ran out of memory).

Usage: ``python3 tools/torch_step_profile.py [--flexicubes | --config FILE
[--modes map_remat,map]]`` from the repository root.
"""
import argparse
import bisect
import collections
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gshell_tpu_torch.geometry import geometry as G  # noqa: E402
from gshell_tpu_torch.ops import bsdf as B  # noqa: E402
from gshell_tpu_torch.ops import shade as S  # noqa: E402
from gshell_tpu_torch.render import render as R  # noqa: E402
from gshell_tpu_torch.render.light import update_pdf  # noqa: E402
from gshell_tpu_torch.utils import spans  # noqa: E402

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


def span_totals(prof, records) -> dict:
    """Per span name of ``records`` (one profiled session's): count, host
    ms, self ms (less the part its child spans cover), and the device ms
    and count of the kernels launched inside it."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != DeviceType.CUDA and e.name().startswith("cuda")}
    kernels = sorted((launch[e.correlation_id()], e.duration_ns()) for e in events
                     if e.device_type() == DeviceType.CUDA and e.correlation_id() in launch
                     and not e.is_user_annotation() and not e.name().startswith(("Memcpy", "Memset")))
    starts = [t for t, _ in kernels]
    children = collections.defaultdict(list)
    for r in records:
        children[r.parent_id].append((r.start_ns, r.end_ns))
    out = {}
    for r in records:
        covered, reached = 0, r.start_ns
        for s, e in sorted(children[r.id]):
            s, e = max(s, reached), min(e, r.end_ns)
            if e > s:
                covered, reached = covered + e - s, e
        lo, hi = bisect.bisect_left(starts, r.start_ns), bisect.bisect_right(starts, r.end_ns)
        t = out.setdefault(r.name, collections.Counter())
        t.update(count=1, host_ms=(r.end_ns - r.start_ns) * 1e-6, self_ms=(r.end_ns - r.start_ns - covered) * 1e-6,
                 device_ms=sum(d for _, d in kernels[lo:hi]) * 1e-6, launches=hi - lo)
    return {k: dict(v) for k, v in sorted(out.items(), key=lambda kv: -kv[1]["host_ms"])}


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


def config_point(path: str, dev):
    """The train step of the config ``path`` at its full width on ``dev``:
    its ``Reconstructor``, a state after the config's SDF pretrain at step
    1000, a draw source, and two ground-truth views of the synthetic skirt
    (white background) as the batch."""
    from gshell_tpu_torch.data.datasets import DatasetMesh
    from gshell_tpu_torch.render.mesh import Mesh, unit_size
    from gshell_tpu_torch.train.setup import gt_light_material, reconstructor_from_flags
    from gshell_tpu_torch.utils.config import load_flags
    from gshell_tpu_torch.utils.rng import TorchDraws
    from gshell_tpu_torch.utils.synthetic_gt import skirt

    flags = load_flags(path)
    rec = reconstructor_from_flags(flags, dev)
    draws = TorchDraws(torch.Generator(dev).manual_seed(chip_smoke.SEED))
    t0 = time.time()
    state = rec.init_state(draws.child("init"), pretrain_steps=flags.sdf_mlp_pretrain_steps)
    torch.cuda.synchronize()
    print(f"init_state ({flags.sdf_mlp_pretrain_steps} pretrain steps): {time.time() - t0:.2f} s", flush=True)
    state.step = 1000
    v, f = skirt()
    mesh = unit_size(Mesh(v_pos=torch.as_tensor(v, device=dev), t_pos_idx=torch.as_tensor(f, device=dev).long()))
    light, mat = gt_light_material(rec.mat_cfg, dev)
    ds = DatasetMesh(mesh, light, mat, rec.mat_cfg, rec.flags, n_views=rec.tcfg.batch, shadows=flags.gt_shadows)
    target = ds.batch(list(range(rec.tcfg.batch)), background="white", rng=np.random.default_rng(0))
    return rec, state, draws, target


def tick_memory(rec, state, draws, target) -> dict:
    """One tick on ``state``: the bytes its forward keeps for the backward,
    and the forward's and the backward's peaks above what was allocated
    before it."""
    for opt in state.optimizers:
        opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    img, depth, reg, _ = rec.geo.tick(
        draws, state.params_geo, state.params_mat, rec.mat_cfg, update_pdf(state.light_base), target, state.step,
        rec.flags, rec.image_loss_fn, use_shadows=rec.tcfg.use_shadows, shadow_scale=1.0, denoiser_sigma=2.0)
    torch.cuda.synchronize()
    out = {"tick_forward_kept_bytes": torch.cuda.memory_allocated() - base,
           "tick_forward_peak_bytes": torch.cuda.max_memory_allocated() - base}
    torch.cuda.reset_peak_memory_stats()
    (img + depth + reg).backward()
    torch.cuda.synchronize()
    out["tick_backward_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    for opt in state.optimizers:
        opt.zero_grad(set_to_none=True)
    return out


def modes_steps(rec, state, draws, target, modes, card):
    """For each ``view_batch_mode`` in ``modes``, from a copy of the same
    state and a draw source of the same seed: :func:`tick_memory`, then one
    warm-up step and three timed steps and their peak memory."""
    import copy
    import dataclasses

    from gshell_tpu_torch.utils.rng import TorchDraws

    pristine = copy.deepcopy(state)
    for mode in modes:
        rec.geo.cfg = dataclasses.replace(rec.geo.cfg, view_batch_mode=mode)
        st = copy.deepcopy(pristine)
        draws = TorchDraws(torch.Generator(rec.device).manual_seed(chip_smoke.SEED + 1))
        torch.cuda.empty_cache()
        secs = []
        try:
            mem = tick_memory(rec, st, draws.child("tick"), target)
            torch.cuda.reset_peak_memory_stats()
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = rec.train_step(st, draws.child(f"step{i}"), target)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as err:
            emit("mode", {"view_batch_mode": mode, "fits": False, "error": str(err).splitlines()[0],
                          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "card": card})
            del st
            continue
        emit("mode", {"view_batch_mode": mode, "fits": True, **mem, "warmup_s": secs[0], "seconds": secs[1:],
                      "median": sorted(secs[1:])[1], "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "nonfinite_grads": int(m["nonfinite_grads"]), "n_faces": int(m["n_faces"]), "card": card})
        del st


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--flexicubes", action="store_true",
                   help="the FlexiCubes step of configs/deepfashion_mc_80.json, not the working point")
    p.add_argument("--config", default=None, help="the train step of this config file at full width")
    p.add_argument("--modes", default="map_remat,map", help="view_batch_mode values to time (with --config)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device found", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = chip_smoke.card_name()
    emit("card", card)
    if args.config:
        rec, state, draws, target = config_point(args.config, dev)
    else:
        rec, state, draws, target = (chip_smoke.flexi_point if args.flexicubes else chip_smoke.working_point)(dev)
    geo, flags = rec.geo, rec.flags
    emit("workload", {"config": args.config, "geometry": type(geo).__name__,
                      "resolution": list(flags.resolution), "n_samples": flags.n_samples,
                      "batch": int(target["mvp"].shape[0]), "grid_res": geo.cfg.grid_res,
                      "view_batch_mode": geo.cfg.view_batch_mode})

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
                        "sdf_net_grad_norm": float(m["sdf_net_grad_norm"]),
                        "stages_watched": len(counts), "card": card})
    if args.config:
        modes_steps(rec, state, draws, target, args.modes.split(","), card)
        return 0

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

    known = {r.id for r in spans.recorded()}
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

    emit("spans", {"by_name": span_totals(prof, [r for r in spans.recorded() if r.id not in known]), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
