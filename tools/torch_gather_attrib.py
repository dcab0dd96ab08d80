#!/usr/bin/env python3
"""Which gathers the backward of the port's train step spends its time in.

Builds a cell of the benchmark (``BENCHMARK.json``; default
``tets128_train``) as ``benchmark.run`` builds it, runs its warm-up steps,
then ``--steps`` steps with every advanced-index gather (``Tensor.__getitem__``
whose result carries autograd's ``IndexBackward0``) and every row gather of
``ops/gather.py`` (``gather_rows``, listed as such) charged to its call site
in the port: the innermost frame of ``gshell_tpu_torch`` that made it, and
that frame's caller in the port.  ``Tensor.__getitem__`` and the row
gather's ``apply`` are replaced for the duration, so gathers made on
autograd's own thread (the recomputed regions of a checkpoint) are caught
too.

For each gather, at its forward: the rows it gathers (index elements), the
row width, the longest run of one index (``torch.unique``), and at its
backward (a gather whose output reaches no loss has none): the rows and
the share of them that are all zero.  Its backward node
runs inside a profiler range, so the device time of the kernels launched
there (aten's ``indexing_backward_kernel*``, and the sort and fill around
it) is charged to the site.  The statistics sync the host; device times
are unaffected, host times are not meaningful.

Prints one JSON line per site, most device time first, then a ``total``
line: the index-backward kernels' device ms a step over all sites against
the whole trace's (``coverage``), and what ``ops/gather.py``'s backward saw
a step (``gather_rows``: its launches, the rows it saw and scattered, the
share it skipped).  Writes the same to ``--json`` (default
``out/gather_attrib.json``, gitignored).

Usage: ``python3 tools/torch_gather_attrib.py [--workload tets128_train]
[--seed N] [--steps 2] [--json PATH]`` from the repository root, on a CUDA
card.
"""
import argparse
import collections
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.trace import collect  # noqa: E402
from gshell_tpu_torch.ops import gather as ga  # noqa: E402

PKG = os.path.join(ROOT, "gshell_tpu_torch") + os.sep
GATHER_PY = os.path.join(PKG, "ops", "gather.py")
RANGE = "bench.gather."  # benchmark.trace keeps ranges with the "bench." prefix
WINDOW = "bench.window"


def site_of(frame) -> str:
    """The innermost two frames of the port on the stack: 'file:line <- file:line'."""
    out = []
    while frame is not None and len(out) < 2:
        f = frame.f_code.co_filename
        if f.startswith(PKG) and f != GATHER_PY:
            out.append(f"{os.path.relpath(f, ROOT)}:{frame.f_lineno}")
        frame = frame.f_back
    return " <- ".join(out) or "(outside the port)"


def linear_index(src, key):
    """(linear row index, row width) of ``src[key]`` for a long index or a
    tuple of long indices over the leading dimensions; None otherwise."""
    keys = key if isinstance(key, tuple) else (key,)
    if not keys or not all(isinstance(k, torch.Tensor) and k.dtype in (torch.int64, torch.int32) for k in keys):
        return None
    lin = torch.zeros((), dtype=torch.int64, device=src.device)
    for d, k in enumerate(keys):
        lin = lin * src.shape[d] + k.long()
    width = 1
    for s in src.shape[len(keys):]:
        width *= s
    return lin.reshape(-1), width


class Attribution:

    def __init__(self):
        self.sites = collections.defaultdict(lambda: {"calls": 0, "rows": 0, "backward_calls": 0, "live_rows": 0,
                                                      "seen_rows": 0, "longest_run": 0, "widths": set(),
                                                      "dtypes": set()})
        self.active = False
        self.orig = torch.Tensor.__getitem__
        self.orig_rows = ga._GatherRows.apply

    def __enter__(self):
        orig, orig_rows, me = self.orig, self.orig_rows, self

        def getitem(src, key):
            out = orig(src, key)
            if me.active and isinstance(out, torch.Tensor) and type(out.grad_fn).__name__ == "IndexBackward0":
                me.hook(src, key, out, site_of(sys._getframe(1)))
            return out

        def rows(src, flat):
            out = orig_rows(src, flat)
            if me.active and out.grad_fn is not None:
                me.hook(src, flat, out, "gather_rows: " + site_of(sys._getframe(1)))
            return out

        torch.Tensor.__getitem__ = getitem
        ga._GatherRows.apply = rows
        return self

    def __exit__(self, *exc):
        torch.Tensor.__getitem__ = self.orig
        ga._GatherRows.apply = self.orig_rows
        return False

    def hook(self, src, key, out, site):
        s = self.sites[site]
        s["calls"] += 1
        s["dtypes"].add(str(src.dtype).replace("torch.", ""))
        li = linear_index(src, key)
        if li is None:  # a boolean mask or a mix with slices: rows distinct or not placed
            width = max(1, src[0].numel() if src.dim() else 1)
            rows = out.numel() // width
        else:
            lin, width = li
            rows = lin.numel()
            if rows:
                s["longest_run"] = max(s["longest_run"], int(torch.unique(lin, return_counts=True)[1].max()))
        s["rows"] += rows
        s["widths"].add(width)
        node, rf = out.grad_fn, []

        def pre(grad_outputs):
            g = grad_outputs[0]
            s["backward_calls"] += 1
            if g is not None and rows:
                live = (g.reshape(rows, -1) != 0).any(1)
                s["seen_rows"] += rows
                s["live_rows"] += int(live.sum())
            r = torch.autograd.profiler.record_function(RANGE + site)
            r.__enter__()
            rf.append(r)

        def post(grad_inputs, grad_outputs):
            if rf:
                rf.pop().__exit__(None, None, None)

        node.register_prehook(pre)
        node.register_hook(post)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="tets128_train")
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--json", default=os.path.join(ROOT, "out", "gather_attrib.json"))
    args = ap.parse_args()
    harness.set_cache_dirs()
    dev = torch.device("cuda", 0)
    found = harness.find_cell(args.workload)
    cell = harness.runner_module(found).Cell(found["config_path"], found["traffic"], args.seed, dev)
    warm = int(found["traffic"]["warm_steps"])
    for k in range(warm):
        cell.step(k)
    torch.cuda.synchronize(dev)
    from torch.profiler import ProfilerActivity, profile, record_function

    before = ga.gather_stats()
    att = Attribution()
    with att:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                att.active = True
                for k in range(warm, warm + args.steps):
                    cell.step(k)
                att.active = False
                torch.cuda.synchronize(dev)
    after = ga.gather_stats()
    trace = collect(prof, WINDOW, args.steps)
    is_index = lambda o: "indexing_backward_kernel" in o.name  # noqa: E731
    total_index_ms = trace.device_s_where(is_index) * 1e3 / args.steps
    rows = []
    for site, s in att.sites.items():
        inside = trace.in_span(RANGE + site)
        index_ms = trace.device_s_where(lambda o: inside(o) and is_index(o)) * 1e3 / args.steps
        node_ms = trace.device_s_where(inside) * 1e3 / args.steps
        rows.append({"site": site, "calls_per_step": s["calls"] / args.steps, "rows_per_step": s["rows"] / args.steps,
                     "backward_calls_per_step": s["backward_calls"] / args.steps,
                     "backward_rows_per_step": s["seen_rows"] / args.steps,
                     "width": sorted(s["widths"]), "dtype": sorted(s["dtypes"]), "longest_run": s["longest_run"],
                     "zero_row_share": (1 - s["live_rows"] / s["seen_rows"]) if s["seen_rows"] else None,
                     "index_bwd_ms_per_step": index_ms, "node_device_ms_per_step": node_ms})
    rows.sort(key=lambda r: -r["node_device_ms_per_step"])
    charged = sum(r["index_bwd_ms_per_step"] for r in rows)
    total = {"total": {"card": torch.cuda.get_device_name(0), "workload": args.workload, "seed": args.seed,
                       "steps": args.steps, "index_bwd_ms_per_step": total_index_ms,
                       "charged_ms_per_step": charged,
                       "coverage": charged / total_index_ms if total_index_ms else None,
                       "gather_rows": {k: (after[k] - before[k]) / args.steps for k in after}}}
    g = total["total"]["gather_rows"]
    g["skipped_share"] = 1 - g["rows_scattered"] / g["rows_seen"] if g["rows_seen"] else None
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(total), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump({"sites": rows, **total}, f, indent=1)


if __name__ == "__main__":
    main()
