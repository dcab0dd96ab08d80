"""Process groups in place of the JAX package's device mesh (PyTorch twin of
``gshell_tpu/parallel/sharding.py``).

The JAX package runs one program over a ``jax.sharding.Mesh``; the port
runs one process per GPU in a ``torch.distributed`` process group, as the
reference's NCCL DDP trainer did (``GMeshDiffusion/lib/diffusion/
trainer_ddp.py:22-187``).  Every rank computes the replicated work itself
from the same seeded draws, parameters stay replicated, and after the
backward the trainer averages every gradient across ranks once per
optimizer step (:func:`average_gradients`: JAX's ``psum`` after the
microbatch scan, the reference's ``no_sync()``).  No
``DistributedDataParallel`` hooks: the U-Net's ``torch.utils.checkpoint``
and the reconstruction tick's recomputation need no ``static_graph``.

Every collective is an ``all_reduce`` or a ``broadcast``.  Those are the
two that gloo supports on CUDA tensors, so the same code runs with NCCL
(one process per card; NCCL refuses two ranks on one device), with gloo
ranks sharing one card, and with gloo ranks on the CPU.  :func:`stitch`
turns per-rank pieces into the replicated whole with one differentiable
``all_reduce``.

A process group of ``None`` means one process: no collective runs.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist


def init_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, backend: Optional[str] = None,
                   device_type: str = "cuda") -> tuple:
    """``init_process_group`` (JAX's ``jax.distributed.initialize``): with
    ``coordinator`` ("host:port" of rank 0) the given world size and rank;
    without, the environment ``torchrun`` sets (``env://``).  ``backend``
    defaults to NCCL on ``cuda`` and gloo on ``cpu``; gloo on ``cuda`` (two
    ranks sharing a card) only when asked for.  → (rank, world size)."""
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs --num-processes and --process-id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                                rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under ``torchrun``, else
    ``cuda:(rank mod device count)``; the CPU as it is."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` over ranks ``0 … n_devices − 1`` (default: all)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = n_devices or dist.get_world_size()
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis_name,))


def make_mesh_multislice(n_slices: int, devices_per_slice: Optional[int] = None,
                         axis_names: tuple = ("dcn", "data"), device_type: str = "cuda"):
    """The (dcn × data) ``DeviceMesh``, slices rank-contiguous.  A batch
    shards over both axes, so for data parallelism it is a data mesh of the
    same size: on a real cluster NCCL picks its own hierarchical rings."""
    from torch.distributed.device_mesh import DeviceMesh

    per = devices_per_slice or dist.get_world_size() // n_slices
    ranks = torch.arange(n_slices * per).reshape(n_slices, per)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def mesh_group(mesh):
    """The process group over every rank of ``mesh`` (the gradient average
    of data parallelism spans all its axes)."""
    if mesh.ndim == 1:
        return mesh.get_group()
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


def default_group():
    """The default group when ``torch.distributed`` is initialized, else
    ``None`` (one process)."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def world(group) -> tuple:
    """(rank, size) in ``group``; (0, 1) for ``None``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def batch_rows(global_batch: int, rank: int, size: int) -> slice:
    """The rows [r·B/W, (r+1)·B/W) of a global batch of B that rank r of W
    holds (JAX's ``P("data")``); B must divide evenly."""
    if global_batch % size:
        raise ValueError(f"a global batch of {global_batch} does not split over {size} ranks")
    n = global_batch // size
    return slice(rank * n, (rank + 1) * n)


def slot_range(n: int, rank: int, size: int) -> tuple:
    """A contiguous [start, stop) share of ``n`` slots: ⌈n/W⌉ each, the last
    rank takes what is left."""
    per = -(-n // size)
    return min(rank * per, n), min((rank + 1) * per, n)


def fsdp_placements(params: dict, n_shards: int, min_size: int = 2 ** 16) -> dict:
    """Each parameter's DTensor placement over a mesh axis of ``n_shards``
    (JAX's ``fsdp_sharding`` rule): ``Shard(axis)`` on its largest axis that
    ``n_shards`` divides, ``Replicate()`` for a scalar, a parameter below
    ``min_size`` elements or one with no such axis.  Only the layout: no
    trainer applies it."""
    from torch.distributed.tensor import Replicate, Shard

    def placement(p):
        if p.ndim == 0 or p.numel() < min_size:
            return Replicate()
        for ax in sorted(range(p.ndim), key=lambda i: -p.shape[i]):
            if p.shape[ax] % n_shards == 0:
                return Shard(ax)
        return Replicate()

    return {name: placement(p) for name, p in params.items()}


@torch.no_grad()
def broadcast_parameters(tensors, group) -> None:
    """Rank 0's values into every rank's ``tensors``, in place (JAX
    replicates the initial state)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t.data, src=src, group=group)


@torch.no_grad()
def average_gradients(params, group, bucket_bytes: int = 1 << 26) -> float:
    """Every parameter's ``.grad`` averaged across ``group``, in place: a
    gradient of at least ``bucket_bytes`` is reduced where it lies, smaller
    ones are packed into buckets of about that size (one ``all_reduce``
    each), so no second full copy of the gradients is made.  A parameter
    without a gradient takes zeros, so that every rank runs the same
    collectives.  Returns the seconds it took (the device synchronized
    before and after, for gradients on a GPU)."""
    if group is None:
        return 0.0
    size = world(group)[1]
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    sync = torch.cuda.synchronize if grads and grads[0].is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(size)

    bucket, nbytes = [], 0

    def flush():
        if bucket:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            reduce(flat)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))
            bucket.clear()

    for g in grads:
        b = g.numel() * g.element_size()
        if b >= bucket_bytes:
            reduce(g)
            continue
        if bucket and (g.dtype != bucket[0].dtype or nbytes + b > bucket_bytes):
            flush()
            nbytes = 0
        bucket.append(g)
        nbytes += b
    flush()
    sync()
    return time.perf_counter() - t0


@torch.no_grad()
def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced across ``group`` (``op`` "sum" or "max"), in place; a
    bool tensor reduces as int32 (the max of a mask is its OR)."""
    if group is None:
        return t
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if t.dtype == torch.bool:
        v = t.to(torch.int32)
        dist.all_reduce(v, op=reduce_op, group=group)
        t.copy_(v > 0)
    else:
        dist.all_reduce(t, op=reduce_op, group=group)
    return t


def mean_metrics(metrics: dict, group) -> dict:
    """Every 0-d tensor of ``metrics`` averaged across ``group`` (one
    ``all_reduce`` in float64; an integer count comes back rounded to its
    dtype), so that every rank reports the same numbers also where its
    replicated work rounds its own way; the other entries as they are."""
    if group is None:
        return metrics
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor) and v.ndim == 0]
    if not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().double() for k in keys])
    dist.all_reduce(vals, group=group)
    vals /= world(group)[1]
    out = dict(metrics)
    for i, k in enumerate(keys):
        dtype = metrics[k].dtype
        out[k] = vals[i].to(dtype) if dtype.is_floating_point else vals[i].round().to(dtype)
    return out


class _Stitch(torch.autograd.Function):
    """Forward: the ``all_reduce(SUM)`` of zero-filled buffers, i.e. every
    rank's pieces in one replicated whole.  Backward: the ``all_reduce(SUM)``
    of the incoming gradient; the zero fill around a rank's own pieces
    keeps only their part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def stitch(x: torch.Tensor, group) -> torch.Tensor:
    """The replicated whole of ``x``, a buffer in which each rank filled its
    own pieces and left zeros elsewhere.  Every rank computes the same loss
    on the stitched buffers, so each rank's pieces receive W × their
    gradient in the backward and the replicated terms W × theirs as well;
    :func:`average_gradients` then gives exactly the gradient of the one
    global loss, whatever the loss (a ratio of means included)."""
    if group is None:
        return x
    if x.requires_grad:
        return _Stitch.apply(x, group)
    return all_reduce_(x.contiguous().clone(), group)
