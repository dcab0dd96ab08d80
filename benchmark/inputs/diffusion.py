"""Inputs of a G-MeshDiffusion cell, made from the seed on the device and
handed alike to the program and to its reference.

* The weights: every convolution and dense kernel from ``U(±√(3/fan_avg))``
  (the init's variance scaling at scale 1, fans counted with the
  receptive field; the init's near-zero output layers are drawn like the
  rest, as in a network past its first updates), biases 0, GroupNorm
  scales 1, in one large draw over the parameters in name order.
* The grids, shaped as baked data: a pool of shapes, each a random
  ellipsoid with a wavy surface, as a 4-channel 128³ grid (the SDF's sign
  and a 3-channel deformation in ±0.45) and a 256³ occupancy grid (±1).
* Each update's batch: ``accumulation`` micro-batches of
  ``micro_batch`` shapes drawn from the pool by the seed and the step."""
from __future__ import annotations

import math

import torch

from ..draws import generator


def fans(name: str, shape) -> tuple:
    rf = math.prod(shape[2:]) if len(shape) > 2 else 1
    if name.startswith("ConvTranspose"):  # (in, out, k, k, k)
        return shape[0] * rf, shape[1] * rf
    return shape[1] * rf, shape[0] * rf  # Conv3d (out, in, k, k, k), Linear (out, in)


@torch.no_grad()
def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: tensor} for ``shapes`` {parameter name: shape}."""
    dev = torch.device(device)
    names = sorted(shapes)
    kernels = [n for n in names if n.endswith(".weight") and len(shapes[n]) >= 2]
    sizes = [math.prod(shapes[n]) for n in kernels]
    u = torch.rand(sum(sizes), generator=generator(seed, dev, "weights"), device=dev)
    out = {}
    for n, part in zip(kernels, torch.split(u, sizes)):
        fan_in, fan_out = fans(n, shapes[n])
        lim = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        out[n] = (part * (2 * lim) - lim).reshape(shapes[n])
    for n in names:
        if n not in out:  # biases 0, GroupNorm scales 1
            out[n] = (torch.ones if n.endswith(".scale") else torch.zeros)(shapes[n], device=dev)
    return out


@torch.no_grad()
def make_pool(cfg: dict, seed: int, device, n_shapes: int) -> dict:
    """{"grid": (N, C, D, D, D), "occgrid": (N, 1, 2D, 2D, 2D)}."""
    dev = torch.device(device)
    d, ch = cfg["grid_size"], cfg["data_ch"]
    gen = generator(seed, dev, "grids")
    grids, occs = [], []
    for _ in range(n_shapes):
        centre = (torch.rand(3, generator=gen, device=dev) - 0.5) * 0.2
        radii = 0.25 + 0.2 * torch.rand(3, generator=gen, device=dev)
        phase = torch.rand(3, generator=gen, device=dev) * 6.283

        def inside(n):
            ax = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n - 0.5
            x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
            r = torch.sqrt(((x - centre[0]) / radii[0]) ** 2 + ((y - centre[1]) / radii[1]) ** 2
                           + ((z - centre[2]) / radii[2]) ** 2)
            wave = 0.08 * torch.sin(9 * x + phase[0]) * torch.sin(7 * y + phase[1]) * torch.sin(8 * z + phase[2])
            return torch.where(r + wave < 1.0, -1.0, 1.0)

        deform = (torch.rand((ch - 1, d, d, d), generator=gen, device=dev) - 0.5) * 0.9
        grids.append(torch.cat([inside(d)[None], deform]))
        occs.append(inside(2 * d)[None])
    return {"grid": torch.stack(grids), "occgrid": torch.stack(occs)}


def batch(pool: dict, seed: int, step: int, accumulation: int, micro_batch: int) -> dict:
    """Update ``step``'s batch: {"grid": (A, B, C, D, D, D), "occgrid": (A, B,
    1, 2D, 2D, 2D)}."""
    dev = pool["grid"].device
    idx = torch.randint(0, pool["grid"].shape[0], (accumulation * micro_batch,),
                        generator=generator(seed, dev, "batch", step), device=dev)
    return {k: v[idx].reshape((accumulation, micro_batch) + tuple(v.shape[1:])) for k, v in pool.items()}
