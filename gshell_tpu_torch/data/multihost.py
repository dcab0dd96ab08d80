"""Per-rank grid loading (PyTorch twin of ``gshell_tpu/data/multihost.py``).

Under a process group every rank draws the same file indices for a step
(``grids.grid_indices``, seeded by (seed, step), the stateless twin of the
reference's epoch-seeded ``DistributedSampler``,
``GMeshDiffusion/lib/diffusion/trainer_ddp.py:79-83``) and opens only the
files behind its own rows: rows [r·B/W, (r+1)·B/W) of each microbatch, the
rows JAX's ``P(None, "data")`` gives the devices of process r.  JAX's
``make_global_batch`` assembles a global array from such per-device
fills; in the port a rank's batch is its fill.
"""
from __future__ import annotations

from typing import Sequence

from ..parallel.sharding import batch_rows
from .grids import GridSampler


class DistributedGridSampler(GridSampler):
    """``GridSampler`` for rank ``rank`` of ``world_size``: the global
    batch of ``batch`` per microbatch, of which it loads and returns its
    rows, (A, batch / world_size, …)."""

    def __init__(self, files: Sequence[str], grad_acc: int, batch: int, rank: int, world_size: int,
                 seed: int = 0, start_step: int = 0, device="cpu"):
        super().__init__(files, grad_acc, batch, seed, start_step, device)
        self._rows = batch_rows(batch, rank, world_size)

    def rows(self) -> slice:
        return self._rows
