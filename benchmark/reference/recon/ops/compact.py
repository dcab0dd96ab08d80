"""Fixed-capacity stream compaction (twin of ``gshell_tpu/ops/compact.py``)."""
from __future__ import annotations

import torch


def nonzero_compact(mask, size: int, fill_value: int):
    """Flat indices of the first ``size`` True elements of ``mask``
    (row-major, ascending), padded with ``fill_value`` — a stable argsort of
    the negated mask, so slot order equals the JAX package's."""
    flat = mask.reshape(-1) != 0
    n = flat.shape[0]
    dev = mask.device
    if n == 0 or size == 0:
        return torch.full((size,), fill_value, dtype=torch.int64, device=dev)
    total = flat.sum()
    perm = torch.argsort((~flat).to(torch.int32), stable=True)
    if size > n:
        perm = torch.nn.functional.pad(perm, (0, size - n))
    idx = perm[:size]
    q = torch.arange(size, device=dev)
    return torch.where(q < total, idx, fill_value)
