"""Baked diffusion grids: the file sampler, the dataset and the splits.

``GridSampler`` is the single-process twin of the JAX package's
``DistributedGridSampler`` (``gshell_tpu/data/multihost.py``; the port's
multi-process one is ``data/multihost.py``): step ``s`` draws its file
indices from ``np.random.default_rng((seed, s))`` (:func:`grid_indices`,
which both share) bit for bit as that sampler does, so a run resumed at
step ``s`` reads the batches a straight run reads.  Files hold the JAX
package's channels-last layout (``grid`` (D, D, D, C), ``occgrid`` (2D,
2D, 2D)); batches are NCDHW.
``GShellGridDataset`` and ``make_splits`` are copies of
``gshell_tpu/data/datasets.py``'s (numpy; ``tests/test_torch_imports.py``
holds them equal)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def grid_indices(seed: int, step: int, n_files: int, count: int) -> np.ndarray:
    """Step ``step``'s file indices, the same on every rank."""
    rng = np.random.default_rng((seed, step))
    return rng.integers(n_files, size=count)


class GridSampler:
    """Seeded random batches over baked ``.npz`` grid files →
    ``{"grid": (A, B, C, D, D, D), "occgrid": (A, B, 1, 2D, 2D, 2D)}`` on
    ``device``, A = ``grad_acc`` microbatches of ``batch``."""

    def __init__(self, files: Sequence[str], grad_acc: int, batch: int, seed: int = 0,
                 start_step: int = 0, device="cpu"):
        if not files:
            raise ValueError("no grid files")
        self.files = list(files)
        self.grad_acc, self.batch = grad_acc, batch
        self.seed, self.step = seed, start_step
        self.device = torch.device(device)

    def indices(self, step: int) -> np.ndarray:
        return grid_indices(self.seed, step, len(self.files), self.grad_acc * self.batch)

    def rows(self) -> slice:
        """The rows of each microbatch this sampler loads: all of them."""
        return slice(0, self.batch)

    def __call__(self) -> dict:
        rows = self.rows()
        idx = self.indices(self.step).reshape(self.grad_acc, self.batch)[:, rows].reshape(-1)
        self.step += 1
        loaded = {}
        for i in np.unique(idx).tolist():
            with np.load(self.files[i]) as z:
                loaded[i] = (np.asarray(z["grid"], np.float32), np.asarray(z["occgrid"], np.float32))
        grid = np.stack([loaded[i][0] for i in idx.tolist()])
        occ = np.stack([loaded[i][1] for i in idx.tolist()])
        occ = occ[..., None] if occ.ndim == 4 else occ
        a, b = self.grad_acc, rows.stop - rows.start
        to = lambda arr: torch.from_numpy(np.ascontiguousarray(np.moveaxis(arr, -1, 1))).to(self.device)
        return {"grid": to(grid).reshape((a, b) + tuple(grid.shape[-1:]) + grid.shape[1:-1]),
                "occgrid": to(occ).reshape((a, b, 1) + occ.shape[1:-1])}


class GShellGridDataset:
    """Baked diffusion grids from a file list (ref
    ``GMeshDiffusion/lib/dataset/gshell_dataset.py`` /
    ``gshell_dataset_aug.py``).  Yields channels-last numpy batches."""

    def __init__(self, file_list: list, use_occ: bool = True):
        self.files = list(file_list)
        self.use_occ = use_occ

    def __len__(self):
        return len(self.files)

    def sample_batch(self, rng: np.random.Generator, batch: int) -> dict:
        idx = rng.integers(0, len(self.files), size=batch)
        grids, occs = [], []
        for i in idx:
            z = np.load(self.files[i])
            grids.append(np.asarray(z["grid"], np.float32))
            if self.use_occ:
                occs.append(np.asarray(z["occgrid"], np.float32)[..., None])
        out = {"grid": np.stack(grids)}
        if self.use_occ:
            out["occgrid"] = np.stack(occs)
        return out


def make_splits(paths: list, train_frac: float = 0.9, seed: int = 0):
    """90/10 shuffled split lists (ref ``GMeshDiffusion/metadata/
    get_splits_lower.py:1-33``)."""
    rng = np.random.default_rng(seed)
    paths = list(paths)
    rng.shuffle(paths)
    k = int(len(paths) * train_frac)
    return paths[:k], paths[k:]
