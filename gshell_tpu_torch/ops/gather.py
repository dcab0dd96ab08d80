"""Row gathers whose backward skips zero-gradient rows.

:func:`gather_rows` is ``src[idx]`` for ``src`` (N, ...) and an integer
``idx`` of any shape.  The forward is aten's ``index_select``, so its
values are those of ``src[idx]`` bit for bit.  Its backward adds each
gradient row into the source row it was gathered from: on a CUDA tensor the
hand-written kernel ``csrc/gather_rows.cu``, which skips every all-zero
gradient row and merges duplicate destinations inside a warp before its f32
atomics; on a CPU tensor the plain version beside it, which skips the same
rows and adds the rest with ``index_put_(accumulate=True)``, the operation
aten's own backward of ``src[idx]`` runs, so the gradient equals aten's bit
for bit.  Skipping is exact: adding +0 or -0 to a sum that starts at +0
changes no bit of it (NaN and Inf rows are not zero and are added).

aten's backward of ``src[idx]`` on the card sorts the indices and gives
each distinct index one thread that adds its duplicates one by one, so its
time is set by the longest run of one index.  The port's gathers have runs
of 1e5-1e6 on rows whose gradient is exactly zero: padded extraction slots
read one sentinel row, background pixels read face 0, padded faces read one
vertex, and each read is masked after the gather.

Counters: ``utils/kernels.kernel_launches()`` counts the kernel's launches
(``gather_rows``); :func:`gather_stats` reads them and the rows the backward
saw and the rows it scattered, summed on each device (it synchronizes: call
it outside a step).
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from ..utils import kernels
from ..utils.spans import span

_stats: dict = {}  # device → int64 (2,): rows seen, rows scattered


def _stats_on(device) -> torch.Tensor:
    t = _stats.get(device)
    if t is None:
        t = _stats[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return t


def gather_stats() -> dict:
    """{"launches", "rows_seen", "rows_scattered"} since the process
    started, over every device (synchronizes each device it reads)."""
    seen = scattered = 0
    for t in _stats.values():
        a, b = t.tolist()
        seen, scattered = seen + a, scattered + b
    return {"launches": kernels.kernel_launches()["gather_rows"], "rows_seen": seen, "rows_scattered": scattered}


def scatter_rows_plain(g, idx, n: int):
    """Plain version: (n, C) sums of the rows of ``g`` (M, C) into rows
    ``idx`` (M,), all-zero rows skipped."""
    live = (g != 0).any(dim=1)
    _stats_on(g.device).add_(torch.stack([torch.tensor(g.shape[0]), live.sum()]))
    out = torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_put_((idx[live],), g[live], accumulate=True)


def scatter_rows(g, idx, n: int):
    """(n, C) with row ``idx[i]`` the sum of the rows ``g[i]`` (M, C) that
    name it.  CUDA tensors: the hand kernel, f32 or bf16 (summed in f32 and
    rounded once, as aten's sum does); CPU tensors: the plain version."""
    if g.device.type == "cpu":
        return scatter_rows_plain(g, idx, n)
    m, c = g.shape
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g: dtype {g.dtype}, expected float32 or bfloat16")
    if idx.dtype != torch.int64 or idx.dim() != 1 or idx.shape[0] != m or idx.device != g.device:
        raise ValueError(f"idx: {idx.dtype} {tuple(idx.shape)} on {idx.device}, expected int64 ({m},) on {g.device}")
    g = g.contiguous()
    out = torch.zeros((n, c), dtype=torch.float32, device=g.device)
    if m and c:
        err = kernels.lib().gs_scatter_rows(
            ctypes.c_void_p(g.data_ptr()), int(g.dtype == torch.bfloat16), ctypes.c_void_p(idx.data_ptr()),
            idx.stride(0), ctypes.c_void_p(out.data_ptr()), m, c,
            ctypes.c_void_p(_stats_on(g.device).data_ptr()), ctypes.c_void_p(kernels.stream_ptr(g)),
        )
        kernels.check(err, "scatter_rows")
    return out if g.dtype == torch.float32 else out.to(g.dtype)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, src, flat):
        ctx.save_for_backward(flat)
        ctx.n = src.shape[0]
        return src.index_select(0, flat)

    @staticmethod
    @once_differentiable  # the kernel's scatter is not differentiated again
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        with span("recon.gather_backward"):
            out = scatter_rows(g.reshape(g.shape[0], math.prod(g.shape[1:])), flat, ctx.n)
        return out.reshape(ctx.n, *g.shape[1:]), None


def gather_rows(src, idx):
    """``src[idx]`` for ``src`` (N, ...) and integer ``idx`` of any shape
    with values in [0, N): (*idx.shape, *src.shape[1:]).  A 0-d ``idx`` is
    aten's select, whose backward copies one row (and keeps a -0)."""
    if idx.dim() == 0:
        return src[idx]
    flat = idx.reshape(-1)
    if flat.dtype != torch.int64:
        flat = flat.long()
    return _GatherRows.apply(src, flat).reshape(*idx.shape, *src.shape[1:])
