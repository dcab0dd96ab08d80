"""Microbenchmark of the port's extractors and of ``pbr_bsdf`` (PyTorch twin
of the repository's ``bench_extract.py``; the tets time is BASELINE.json's
"extraction ms/grid").

Usage::

    python -m gshell_tpu_torch.bench_extract [RES] [--device cuda|cpu]

Times, each as one call, a sync, then the mean of 20 calls up to a sync:

* the tets extractor at RES (default 64) in full, as the JAX bench calls
  it: the template, the mSDF cut, tangents and the cut mesh's smooth
  normals, on the SDF 0.35 − |p| and the mSDF z + 0.05;
* FlexiCubes at min(RES, 80) on |p| − 0.35 (its SDF is inside-negative)
  and the same mSDF;
* ``ops/bsdf.pbr_bsdf`` forward, and the gradient of its sum with respect
  to (kd, arm), on [8, 512, 512, 3] uniforms (normals normalized).

The port's extractors are eager PyTorch: where they read a count back to
the host, that synchronization is part of what is timed.  Inputs are drawn
from a seeded ``torch.Generator`` on the device.  Prints ONE JSON line on
stdout (``gshell_tet_extraction_ms(res{R})``, ms/grid, ``vs_baseline``
null, the device's name; not rounded) and the three timings on ``#`` lines
on stderr.  Runs on the card unless ``--device cpu`` is given; without a
card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .geometry.cube_grid import build_cube_grid
from .geometry.gshell_flexicubes import GShellFlexiCubes
from .geometry.gshell_tets import GShellTets
from .geometry.tet_grid import build_tet_grid
from .ops.bsdf import pbr_bsdf
from .ops.mesh_ops import auto_normals
from .train.setup import resolve_device, sync

PROG = "gshell_tpu_torch.bench_extract"
FLEXI_MAX_RES = 80
BSDF_SHAPE = (8, 512, 512)


def bench_fn(fn, args, device, n: int = 20) -> float:
    """ms per call: one call, sync, then ``n`` calls up to a sync."""
    fn(*args)
    sync(device)
    t0 = time.time()
    for _ in range(n):
        fn(*args)
    sync(device)
    return (time.time() - t0) / n * 1000.0


def tets_case(res: int, device):
    """(fn, (pos, sdf, msdf)): the full tets extraction at ``res``;
    ``fn`` returns (GShellMesh with tangents, the cut mesh's normals)."""
    grid = build_tet_grid(res)
    ex = GShellTets(grid, device)
    pos = torch.as_tensor(grid.verts, device=device)

    def extract(p, s, m):
        mesh = ex(p, s, m, compute_tangents=True)
        return mesh, auto_normals(mesh.verts, mesh.faces, mesh.face_valid)

    return extract, (pos, 0.35 - torch.linalg.norm(pos, dim=-1), pos[:, 2] + 0.05)


def flexicubes_case(res: int, device):
    """(fn, (x, s, nu)): FlexiCubes at ``min(res, 80)`` without weights
    (training split); ``fn`` returns the FlexiMesh."""
    grid = build_cube_grid(min(res, FLEXI_MAX_RES))
    fc = GShellFlexiCubes(grid, device)
    x = torch.as_tensor(grid.verts, device=device)
    return (lambda p, s, m: fc(p, s, m)), (x, torch.linalg.norm(x, dim=-1) - 0.35, x[:, 2] + 0.05)


def bsdf_inputs(shape, device, seed: int = 0) -> tuple:
    """(kd, arm, pos, nrm, view_pos, light_pos), each ``shape + (3,)``
    uniform in [0, 1), the normals normalized; kd and arm require grad."""
    gen = torch.Generator(device).manual_seed(seed)
    kd, arm, pos, nrm, view, light = (torch.rand(tuple(shape) + (3,), generator=gen, device=device)
                                      for _ in range(6))
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
    return kd.requires_grad_(True), arm.requires_grad_(True), pos, nrm, view, light


def bsdf_forward(*args):
    with torch.no_grad():
        return pbr_bsdf(*args)


def bsdf_backward(*args):
    """d sum(pbr_bsdf) / d (kd, arm)."""
    return torch.autograd.grad(pbr_bsdf(*args).sum(), args[:2])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    p.add_argument("res", type=int, nargs="?", default=64, help="tet grid resolution (default 64)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device, PROG)
    res = args.res

    ms = bench_fn(*tets_case(res, device), device)
    print(f"# gshell_tets extraction res{res}: {ms:.2f} ms/grid", file=sys.stderr)
    fn, fc_args = flexicubes_case(res, device)
    ms_fc = bench_fn(fn, fc_args, device)
    print(f"# flexicubes extraction res{min(res, FLEXI_MAX_RES)}: {ms_fc:.2f} ms/grid", file=sys.stderr)
    b, r, _ = BSDF_SHAPE
    inputs = bsdf_inputs(BSDF_SHAPE, device)
    ms_fwd = bench_fn(bsdf_forward, inputs, device)
    ms_bwd = bench_fn(bsdf_backward, inputs, device)
    print(f"# pbr_bsdf [{b},{r},{r}] fwd {ms_fwd:.2f} ms / bwd {ms_bwd:.2f} ms", file=sys.stderr)

    out = {"metric": f"gshell_tet_extraction_ms(res{res})", "value": ms, "unit": "ms/grid", "vs_baseline": None,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(out), flush=True)
    return {"line": out, "flexicubes_ms": ms_fc, "flexicubes_res": min(res, FLEXI_MAX_RES),
            "pbr_bsdf_fwd_ms": ms_fwd, "pbr_bsdf_bwd_ms": ms_bwd}


if __name__ == "__main__":
    main()
