"""Inputs of a G-Shell-on-FlexiCubes cell, made from the seed on the device
and handed alike to the program and to its reference.

Those of a marching-tets cell (:mod:`.reconstruction`) on FlexiCubes'
lattice: the (voxel_grid + 1)³ vertices of the voxel grid, centred and
scaled as ``GShellFlexiGeometry.verts`` places them, which is the lattice
``reconstruction.lattice_verts`` builds for a grid of ``voxel_grid``.
FlexiCubes' field has the sphere init's sign, negative inside (its
occupancy is ``s < 0``; ``sdf_lattice`` negates it into an occluder), the
sign :func:`reconstruction.bell` fits, so the SDF MLP is fitted to the same
solid the skirt bounds, and the direct mSDF cuts it open at the waist and
hem with ν ≥ 0 kept.  ``cube_weights`` (C, 21) are zero, as the port
initialises them: every α and β weight 1 and γ ½ after their squashing.
The targets, the batches and Adam's warm moments are those of
:mod:`.reconstruction`."""
from __future__ import annotations

import dataclasses

import torch

from . import reconstruction

N_CUBE_WEIGHTS = 21  # β (12) ++ α (8) ++ γ (1)


def lattice_flags(flags):
    """``flags`` with the tets lattice's size set to the voxel grid's."""
    return dataclasses.replace(flags, gshell_grid=flags.voxel_grid)


def make_params(flags, seed: int, device, fit_steps: int, fit_points: int):
    """→ (params_geo, params_mat, light_base) on ``device``."""
    geo, mat, light = reconstruction.make_params(lattice_flags(flags), seed, device, fit_steps, fit_points)
    geo["cube_weights"] = torch.zeros((flags.voxel_grid ** 3, N_CUBE_WEIGHTS), device=torch.device(device))
    return geo, mat, light
