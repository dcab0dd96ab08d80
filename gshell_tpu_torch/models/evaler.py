"""Generation modes of G-MeshDiffusion (PyTorch twin of
``gshell_tpu/models/evaler.py``): unconditional sample dumps, slerp
interpolation between prior noises, and partial-shape inpainting by
re-noising the known region at every step."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .sampling import _labels, _mask, ddim_loop, ddim_timesteps, slerp
from .sde import VPSDE, ancestral_step, perturb


def uncond_gen(sampler: Callable, draws, n_samples: int, save_fn: Callable):
    """Draw ``n_samples`` (sample ``i`` from ``draws.child("sample{i}")``) and
    hand each (grid, occ) to ``save_fn(i, x, occ)``."""
    for i in range(n_samples):
        x, occ = sampler(draws.child(f"sample{i}"))
        save_fn(i, x, occ)


@torch.no_grad()
def uncond_gen_interp(sde: VPSDE, eps_fn: Callable, shape: tuple, occ_shape: Optional[tuple], draws,
                      n_pairs: int, n_interp: int = 8, n_steps: int = 100, feature_mask=None,
                      occ_mask=None):
    """For each pair ``p`` (draws ``"pair{p}/z0"``, ``"z1"``, ``"zo0"``,
    ``"zo1"``) decode ``n_interp`` slerps between two prior noises with the
    same deterministic quad-schedule DDIM → rows of (x, x_occ)."""
    seq = ddim_timesteps(sde.N, n_steps, "quad")
    dev = sde.discrete_betas.device
    results = []
    for p in range(n_pairs):
        d = draws.child(f"pair{p}")
        z0, z1 = d.normal("z0", shape).to(dev), d.normal("z1", shape).to(dev)
        zo0 = d.normal("zo0", occ_shape).to(dev) if occ_shape else None
        zo1 = d.normal("zo1", occ_shape).to(dev) if occ_shape else None
        row = []
        for t in np.linspace(0.0, 1.0, n_interp).tolist():
            z = slerp(z0, z1, t)
            zo = slerp(zo0, zo1, t) if occ_shape else None
            row.append(ddim_loop(sde, eps_fn, z, zo, seq, feature_mask, occ_mask))
        results.append(row)
    return results


@torch.no_grad()
def cond_gen(sde: VPSDE, eps_fn: Callable, condition, cond_mask, draws, shape: tuple, feature_mask=None,
             occ_shape: Optional[tuple] = None, occ_mask=None, occ_condition=None, occ_cond_mask=None):
    """Inpainting with the ancestral sampler: at every step the known region
    (``cond_mask`` 1) is overwritten by the condition re-noised to level
    t − 1.  The occupancy grid is sampled jointly, and with
    ``occ_condition`` / ``occ_cond_mask`` a known occupancy region is
    inpainted too.  Step ``i`` draws ``"step{i}/x"``, ``"step{i}/cond"``,
    ``"step{i}/x_occ"`` and ``"step{i}/occ_cond"`` → (x, x_occ)."""
    dev = sde.discrete_betas.device
    x = draws.normal("x", shape).to(dev)
    x_occ = draws.normal("x_occ", occ_shape).to(dev) if occ_shape else None
    for i in range(sde.N):
        t = sde.N - 1 - i
        labels = _labels(shape, t, dev)
        eps, eps_occ = eps_fn(x, x_occ, labels)
        step = draws.child(f"step{i}")
        x_new, x_mean = ancestral_step(sde, step.normal("x", shape).to(dev), x, eps.float(), t)
        x_new = x_mean if t == 0 else x_new
        cond_t = perturb(sde, condition, torch.clamp(labels - 1, min=0), step.normal("cond", shape).to(dev))
        x_new = _mask(cond_t * cond_mask + x_new * (1.0 - cond_mask), feature_mask)
        if x_occ is not None:
            o_new, o_mean = ancestral_step(sde, step.normal("x_occ", occ_shape).to(dev), x_occ,
                                           eps_occ.float(), t)
            o_new = o_mean if t == 0 else o_new
            if occ_condition is not None:
                o_cond_t = perturb(sde, occ_condition, torch.clamp(labels - 1, min=0),
                                   step.normal("occ_cond", occ_shape).to(dev))
                o_new = o_cond_t * occ_cond_mask + o_new * (1.0 - occ_cond_mask)
            x_occ = _mask(o_new, occ_mask)
        x = x_new
    return x, x_occ
