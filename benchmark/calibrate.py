"""The readings that a cell's limits are set from (``cells/<name>.json``).

``python3 -m benchmark.calibrate --workload NAME --seeds S1,S2,... [--fault-seeds F1,...] [--twice] [--out FILE]``

For each seed, in one process: the program's first ``follow_steps`` steps
from the seed's state and inputs, recorded; with ``--twice`` the same again
in a second program built alike (the program against itself); the
program's state freed; the reference over the same steps; the control (the
reference in the precision below the configuration's: TF32 for a float32
cell, float8 operands for a bfloat16 one).  The compared numbers of
program against reference are the lower readings, those of the control
against the reference the control's.  For each fault seed, the program
with half of each batch left out (the mean taken over the rest) against
the reference.  A step that leaves the state unchanged reads 1 on
``change`` by the comparison's measure and needs no run.  Prints one JSON
line a seed and writes the whole records to ``--out``.  The benchmark's
own runs never run this."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .compare import compare
from .harness import find_cell, runner_module, set_cache_dirs, sync


def program_record(runner, found, seed, device, fault=None) -> dict:
    import torch

    cell = runner.Cell(found["config_path"], found["traffic"], seed, device, fault=fault)
    record = cell.follow(int(found["traffic"]["follow_steps"]))
    cell.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return cell, record


def diagnostics(cell, n: int, spec: dict, which: str) -> dict:
    """Two more readings of the reference against itself: ``deterministic``,
    both runs under ``torch.use_deterministic_algorithms`` (a gap that
    vanishes there comes from the order of floating-point accumulation);
    ``reorder``, a second run with cuDNN's benchmark mode picking its own
    algorithms; ``channels_last``, a second run with the convolutions in
    that layout (both sound changes of rounding order, at the same
    precision)."""
    import torch

    if which == "channels_last":
        return compare(cell.reference(n, channels_last=True), cell.reference(n), **spec)

    if which == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a, b = cell.reference(n), cell.reference(n)
        finally:
            torch.use_deterministic_algorithms(False)
        return compare(b, a, **spec)
    a = cell.reference(n)
    torch.backends.cudnn.benchmark = True
    try:
        b = cell.reference(n)
    finally:
        torch.backends.cudnn.benchmark = False
    return compare(b, a, **spec)


def reading(runner, found, seed: int, device, fault=None, twice: bool = False, diagnose: str = "") -> dict:
    import torch

    n = int(found["traffic"]["follow_steps"])
    spec = found["limits"]["compare"]
    t0 = time.perf_counter()
    cell, program = program_record(runner, found, seed, device, fault)
    records = {"program": program}
    if twice:
        records["program_again"] = program_record(runner, found, seed, device, fault)[1]
    records["reference"] = ref = cell.reference(n)
    if fault is None:
        records["control"] = cell.reference(n, lower=True)
    sync(device)
    out = {"seed": seed, "fault": fault, "seconds": time.perf_counter() - t0,
           "numbers": {k: compare(r, ref, **spec) for k, r in records.items() if k != "reference"},
           "losses": {k: r["losses"] for k, r in records.items()}}
    if twice:
        out["numbers"]["program_vs_again"] = compare(records["program_again"], program, **spec)
    if diagnose:
        out["numbers"]["reference_" + diagnose] = diagnostics(cell, n, spec, diagnose)
    if n > spec["loss_steps"]:  # also the numbers over every step followed, by the worst leaf
        full = {"loss_steps": n, "change_step": n, "grad_leaf": "worst"}
        out["numbers_all_steps"] = {k: compare(r, ref, **full) for k, r in records.items() if k != "reference"}
    del cell
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, {k: {kk: vv for kk, vv in r.items() if kk != "evaluations"} for k, r in records.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.calibrate", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--twice", action="store_true")
    p.add_argument("--follow", type=int, default=0, help="steps to follow (default: the traffic's)")
    p.add_argument("--diagnose", choices=("", "deterministic", "reorder", "channels_last"), default="",
                   help="also read the reference against itself (see diagnostics())")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    set_cache_dirs()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # lets cuBLAS run deterministically
    import torch

    if not torch.cuda.is_available():
        print("benchmark.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    found = find_cell(args.workload)
    if args.follow:
        found["traffic"]["follow_steps"] = args.follow
    runner = runner_module(found)
    rows, records = [], []
    jobs = [(int(s), None) for s in args.seeds.split(",") if s] + \
        [(int(s), "half_batch") for s in args.fault_seeds.split(",") if s]
    for seed, fault in jobs:
        row, rec = reading(runner, found, seed, device, fault, twice=args.twice and fault is None,
                           diagnose=args.diagnose if fault is None else "")
        rows.append(row)
        records.append({"seed": seed, "fault": fault, **rec})
        print(json.dumps(row), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(0), "readings": rows,
                           "records": records}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
