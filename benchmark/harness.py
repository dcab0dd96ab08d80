"""One run of one cell of ``BENCHMARK.json``.

``python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1``
from the root of a checkout:

1. finds the cell, its configuration file (``configs/``), its traffic mix
   (``traffic/<name>.json``), the limits of its comparison
   (``cells/<name>.json``) and the runner that its configuration names
   (``runners/<runner>.py``);
2. builds the program's state and inputs from the seed, and runs the
   traffic's first ``follow_steps`` steps, recording what the comparison
   reads, then more up to ``warm_steps``: they warm every shape the window
   uses;
3. measures: steps one after another for ``--seconds`` on the host clock,
   the rate being all the work over all the time up to the synchronization
   after the last step;
4. with ``--trace 1`` then profiles ``trace_steps`` more steps and reads
   the cell's per-layer metrics (``metrics/<name>.py``) instead of the
   end-to-end ones;
5. reads the peak memory, frees the program's state, runs the plain
   reference over the same first steps and compares
   (:mod:`benchmark.compare`);
6. checks that no JAX module was loaded, prints each compared number beside
   its limit on standard error, then one JSON line on standard output.

Exits 2 without a card (or with fewer than the cell asks for) and 3 when a
JAX module is loaded, printing no result."""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "gshell_tpu")  # whole top-level module names
WINDOW_SPAN = "bench.window"


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its kernels under ``gshell_tpu_torch/_build/`` by itself)."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str, root: str = ROOT) -> dict:
    """{"cell", "config" (entry), "config_path", "config_file" (its data),
    "traffic", "limits", "manifest"} of ``workload`` in the checkout at
    ``root``."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config_path = os.path.join(root, config["file"])
    return {"cell": cell, "config": config, "config_path": config_path, "config_file": load_json(config_path),
            "traffic": load_json(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")),
            "limits": load_json(os.path.join(bench_dir, "cells", workload + ".json")), "manifest": manifest,
            "bench_dir": bench_dir}


def runner_module(found: dict):
    return importlib.import_module(f"benchmark.runners.{found['config_file']['runner']}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(found: dict, kind: str) -> list:
    """The manifest's ``end_to_end`` or ``per_layer`` entries this cell
    reports: a metric with ``workloads`` where it lists the cell, one
    without wherever the end-to-end metric it moves (or, end to end, it
    itself) is reported."""
    m = found["manifest"]
    name = found["cell"]["name"]
    e2e = [e for e in m["end_to_end"] if name in e.get("workloads", [name])]
    if kind == "end_to_end":
        return e2e
    moved = {e["name"] for e in e2e}
    return [p for p in m["per_layer"]
            if (name in p["workloads"] if "workloads" in p else p["moves"] in moved)]


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def card_name(torch) -> str:
    return torch.cuda.get_device_name(0)


class Context:
    """What a per-layer reader reads: ``found`` (:func:`find_cell`),
    ``trace`` (a :class:`benchmark.trace.Trace` of the profiled steps),
    ``reference`` (the reference's record), ``window_s``, ``window_steps``
    and ``units_per_step`` of the timed window, ``on_card``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run(args, t_start: float) -> int:
    set_cache_dirs()
    found = find_cell(args.workload)
    import torch

    chips = int(found["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return measure(args, found, torch.device("cuda", 0), t_start)


def measure(args, found: dict, device, t_start: float) -> int:
    """Steps 2-6 of the module's docstring on ``device`` (the tests drive
    it on the CPU, where it reports no device numbers)."""
    import torch

    traffic, limits = found["traffic"], found["limits"]
    runner = runner_module(found)
    on_card = device.type == "cuda"
    phases = {"imports": time.perf_counter() - t_start}
    cell = runner.Cell(found["config_path"], traffic, args.seed, device, fault=getattr(args, "fault", None))
    sync(device)
    phases["build_and_inputs"] = time.perf_counter() - t_start
    n_follow = int(traffic["follow_steps"])
    program = cell.follow(n_follow)
    phases["followed_steps"] = time.perf_counter() - t_start
    for k in range(n_follow, int(traffic["warm_steps"])):
        cell.step(k)
    k = max(n_follow, int(traffic["warm_steps"]))
    sync(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    losses, marks = [], []
    while time.perf_counter() - t0 < args.seconds:
        losses.append(cell.step(k))
        marks.append(time.perf_counter() - t0)
        k += 1
    sync(device)
    window_s = time.perf_counter() - t0
    print(f"# setup {setup_s!r} s (ended by then: {phases}); window {window_s!r} s; host clock as each step "
          f"returned: {marks}", file=sys.stderr)
    attempted = len(losses)
    failed = sum(1 for v in losses if not math.isfinite(float(v)))
    print(f"# {cell.notes()}", file=sys.stderr)

    trace = None
    if args.trace:
        t_trace = time.perf_counter()
        trace = profile_steps(cell, k, int(traffic["trace_steps"]), device)
        print(f"# traced {traffic['trace_steps']} steps and read the profiler's events in "
              f"{time.perf_counter() - t_trace!r} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    cell.free()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = cell.reference(n_follow)
    sync(device)
    print(f"# the reference followed {n_follow} step(s) in {time.perf_counter() - t_ref!r} s", file=sys.stderr)
    from .compare import compare

    numbers = compare(program, reference, **limits["compare"])
    # JSON has no infinity: a gap that is not a number is printed as the largest float
    compared = {k_: {"value": min(v, sys.float_info.max), "limit": limits["limits"][k_]}
                for k_, v in numbers.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())

    dev_info = {"platform": "gpu" if on_card else device.type, "kind": card_name(torch) if on_card else device.type,
                "count": 1, "memory_peak_bytes": peak}
    metrics = {}
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if args.trace:
        ctx = Context(found=found, trace=trace, reference=reference, window_s=window_s,
                      window_steps=attempted, units_per_step=cell.units_per_step, on_card=on_card)
        for entry in cell_metrics(found, "per_layer"):
            value = metric_reader(entry["name"], found["bench_dir"])(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        t_read = time.perf_counter()
        dev_info["busy_s"] = trace.busy_s()
        dev_info["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_device_ops(), "idle_gaps": trace.idle_gaps()}
        print(f"# read the per-layer metrics and the breakdown in {time.perf_counter() - t_read!r} s",
              file=sys.stderr)
    else:
        for entry in cell_metrics(found, "end_to_end"):
            name = entry["name"]
            if name == "setup_s":
                value = setup_s
            elif name == "peak_mem_gib":
                value = peak / 2**30 if peak is not None else None
            elif name == traffic["rate_metric"]:
                value = attempted * cell.units_per_step / window_s
            else:
                raise SystemExit(f"benchmark: no way to take the end-to-end metric {name!r} in this cell")
            if value is not None:
                metrics[name] = {"value": value, "unit": entry["unit"]}
    out.update(metrics=metrics, device=dev_info, compared=compared)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules {bad} are loaded in this process", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def profile_steps(cell, k0: int, n: int, device):
    """``n`` steps from step ``k0`` under ``torch.profiler``, inside a span
    ``bench.window`` that ends after the device has finished → a Trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import collect

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with cell.spans():
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                for k in range(k0, k0 + n):
                    cell.step(k)
                sync(device)
    return collect(prof, WINDOW_SPAN, n)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    return run(parse(argv), t_start)
