"""Bake fitted G-Shell states into diffusion training grids (twin of
``bake_grids.py``).

Usage:
  python -m gshell_tpu_torch.bake_grids --states 'out/df*/state.pt' --grid-res 64 --out-dir baked/

Each state is a ``.pt`` file holding ``{"params_geo": {...}}`` with tensors:
the port's ``state.pt`` as ``train_gshell`` writes it, or a bare dict of
geometry parameters.  The field parameterization is read from its keys, as
the JAX tool does: ``sdf_net`` (an SDF MLP) or ``sdf`` (one value per
lattice vertex), ``msdf_net`` or ``msdf``.  Each shape becomes
``OUT_DIR/<state's directory name>.npz`` with the (2R)³×4 ``grid``, the
(4R)³ ``occgrid`` and their masks, channels-last as the JAX package writes
them.  Runs on ``--device cuda`` unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from .geometry.generative_decode import GenerativeCodec
from .geometry.geometry import GeometryConfig, GShellGeometry
from .train.setup import resolve_device

PROG = "gshell_tpu_torch.bake_grids"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=PROG, description="bake G-Shell states into grids (PyTorch port)")
    p.add_argument("--states", type=str, required=True, help="glob of state .pt files")
    p.add_argument("--grid-res", type=int, default=64)
    p.add_argument("--out-dir", type=str, default="baked")
    p.add_argument("--scale", type=float, default=1.4)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def _tensors(node, device):
    if isinstance(node, dict):
        return {k: _tensors(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tensors(v, device) for v in node]
    return torch.as_tensor(node).detach().float().to(device)


def main(argv=None) -> dict:
    """Bake every state; returns {name: path of its .npz}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, PROG)
    os.makedirs(args.out_dir, exist_ok=True)
    geo = codec = None
    out = {}
    for path in sorted(glob.glob(args.states)):
        record = torch.load(path, map_location="cpu", weights_only=True)
        params = _tensors(record["params_geo"], device)
        if geo is None:
            geo = GShellGeometry(GeometryConfig(grid_res=args.grid_res, scale=args.scale,
                                                use_sdf_mlp="sdf_net" in params,
                                                use_msdf_mlp="msdf_net" in params), device)
            codec = GenerativeCodec(geo.extractor)
        v_def, sdf, msdf = geo.fields(params)
        baked = codec.bake(v_def, sdf, msdf, params["deform"])
        name = os.path.basename(os.path.dirname(path)) or "shape"
        out[name] = os.path.join(args.out_dir, f"{name}.npz")
        np.savez_compressed(out[name], **{k: getattr(baked, k).cpu().numpy() for k in baked._fields})
        print(f"baked {name}", flush=True)
    return out


if __name__ == "__main__":
    main()
