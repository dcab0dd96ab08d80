"""Run a function of this module on W gloo ranks on the CPU, for the tests of
the port's ``torch.distributed`` paths (``tests/test_torch_parallel.py``,
``tests/test_torch_dist_diffusion.py``, ``tests/test_torch_banded.py``).

:func:`run_ranks` starts W fresh interpreters, each with one thread; rank r
joins a gloo group on a free local port, calls ``fn(rank, world, job)``
with the job :func:`run_ranks` was given (written with ``torch.save``) and
saves what it returns.  A rank that fails or outlives ``timeout`` fails
the call, and every rank is killed.  The workers below import nothing of
JAX: the tests compute the JAX side in their own process and hand it over
in the job.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

_MAIN = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch_dist
torch_dist._rank_main(*sys.argv[3:])
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argvs: list, timeout: float, env_extra: dict | None = None, cwd: str = ROOT) -> list:
    """Run one process per argv at once → their (stdout, stderr); raises if
    one exits non-zero or outlives ``timeout`` (all are killed)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env_extra or {})}
    env.pop("JAX_PLATFORMS", None)
    # a process group of their own: torchrun signals its group on exit
    procs = [subprocess.Popen(a, env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for a in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
        raise AssertionError("a rank outlived its timeout:\n" + "\n".join(e[-2000:] for _, e in outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise AssertionError(f"a rank exited {p.returncode}:\n{o[-2000:]}\n{e[-4000:]}")
    return outs


def run_ranks(fn: str, world: int, job: dict, tmp_path, timeout: float = 120.0) -> list:
    """``fn(rank, world, job)`` on ``world`` gloo ranks → each rank's result."""
    job_path = os.path.join(str(tmp_path), f"{fn}_job.pt")
    torch.save(job, job_path)
    port = free_port()
    outs = [os.path.join(str(tmp_path), f"{fn}_rank{r}.pt") for r in range(world)]
    launch([[sys.executable, "-c", _MAIN, ROOT, TESTS, fn, str(r), str(world), str(port), job_path, outs[r]]
            for r in range(world)], timeout)
    return [torch.load(o, weights_only=False) for o in outs]


def _rank_main(fn, rank, world, port, job_path, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        result = globals()[fn](rank, world, torch.load(job_path, weights_only=False))
        torch.save(result, out_path)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- workers


def stitch_and_shade(rank, world, job):
    """The meshes' shapes and groups, the stitch's value and gradient, and
    ``pixel_sharded_shade`` on the job's pixels."""
    import torch.distributed as dist

    from gshell_tpu_torch.ops.shade import env_shade
    from gshell_tpu_torch.parallel.sharding import make_mesh, make_mesh_multislice, mesh_group, stitch
    from gshell_tpu_torch.parallel.sharding import world as rank_and_size
    from gshell_tpu_torch.parallel.spatial import pixel_sharded_shade
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.utils.rng import TorchDraws

    group = dist.group.WORLD
    x = torch.arange(8.0, requires_grad=True)
    mine = torch.zeros(8)
    mine[rank * 4:(rank + 1) * 4] = 1.0
    whole = stitch(x * mine, group)
    (whole * torch.arange(8.0)).sum().backward()
    s = job["shade"]
    out = pixel_sharded_shade(env_shade, group)(
        TorchDraws(torch.Generator().manual_seed(rank)), s["mask"], s["pos"], s["pos"], s["nrm"], s["view"],
        s["kd"], s["ks"], update_pdf(s["light"]), n_samples_x=2, bsdf="diffuse", shadow_scale=0.0)
    meshes = {"data": make_mesh(device_type="cpu"), "dcn_data": make_mesh_multislice(world, 1, device_type="cpu")}
    return {"whole": whole.detach(), "grad": x.grad, "diffuse": out.diffuse,
            "meshes": {k: (tuple(m.mesh.shape), m.mesh_dim_names, rank_and_size(mesh_group(m))) for k, m in meshes.items()}}


def diffusion_steps(rank, world, job):
    """``job["steps"]`` data-parallel trainer steps from the job's weights,
    each with the JAX trainer's global draws replayed, on this rank's rows;
    then the checkpoint written and restored."""
    from gshell_tpu_torch.models import losses
    from gshell_tpu_torch.models.ema import EMA
    from gshell_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
    from gshell_tpu_torch.parallel.sharding import batch_rows, make_mesh
    from gshell_tpu_torch.train.diffusion import DiffusionTrainConfig, DiffusionTrainer, DiffusionTrainState
    from gshell_tpu_torch.utils import checkpoint
    from gshell_tpu_torch.utils.rng import ReplayDraws

    tr = DiffusionTrainer(DiffusionTrainConfig(**job["train"]), UNet3DConfig(**job["unet"]), job["fm"], job["om"],
                          "cpu", make_mesh(device_type="cpu"))
    model = UNet3D(UNet3DConfig(**job["unet"]))
    model.load_state_dict(job["weights"])
    params = list(model.parameters())
    c = tr.cfg
    st = DiffusionTrainState(model, losses.make_optimizer(params, c.lr, c.warmup, c.grad_clip, c.weight_decay),
                             EMA(params))
    rows = batch_rows(job["batch"]["grid"].shape[1], rank, world)
    batch = {k: v[:, rows] for k, v in job["batch"].items()}
    masks = []
    if job.get("record_dropout"):
        import torch.nn.functional as F

        plain = F.dropout

        def recorded(x, p=0.5, training=True, inplace=False):
            out = plain(x, p, training, inplace)
            masks.append(out == 0)
            return out

        F.dropout = recorded
    losses_, norms = [], []
    for draws in job["draws"][:job["steps"]]:
        st, m = tr.train_step(st, ReplayDraws(lambda kind, name, shape, lo, hi, d=draws: d[name]), batch)
        losses_.append(m["loss"])
        norms.append(m["grad_norm"])
    out = {"loss": losses_, "grad_norm": norms, "params": [p.detach().clone() for p in params],
           "mu": [t.clone() for t in st.opt.mu], "nu": [t.clone() for t in st.opt.nu],
           "ema": [t.clone() for t in st.ema.params], "masks": masks}
    if job.get("checkpoint"):
        writes = []
        save = checkpoint.save
        checkpoint.save = lambda path, obj: (writes.append(path), save(path, obj))
        tr.save_checkpoint(job["checkpoint"], st)
        checkpoint.save = save
        fresh = DiffusionTrainState(UNet3D(UNet3DConfig(**job["unet"])), None, None)
        fresh.opt = losses.make_optimizer(list(fresh.model.parameters()))
        fresh.ema = EMA(list(fresh.model.parameters()))
        fresh = tr.restore_checkpoint(job["checkpoint"], fresh)
        out["writes"] = writes
        out["restored"] = [p.detach().clone() for p in fresh.model.parameters()]
        out["restored_step"] = fresh.step
    return out


def banded_step(rank, world, job):
    """One ``Reconstructor(spatial=…)`` step over the group from the job's
    state → the metrics and the parameters after the step."""
    from torch_banded import banded_reconstructor, step_record

    rec, state, target, draws = banded_reconstructor(job["kind"], job["spatial"], job["state"])
    return step_record(rec, state, target, draws)


def sharded_extraction(rank, world, job):
    """The tets extraction with its per-slot stages split over the group,
    and the gradients of the job's weighted sum of its outputs."""
    import torch.distributed as dist

    from gshell_tpu_torch.geometry.gshell_tets import GShellTets
    from gshell_tpu_torch.geometry.tet_grid import build_tet_grid

    ext = GShellTets(build_tet_grid(job["res"]), "cpu")
    sdf = job["sdf"].clone().requires_grad_(True)
    msdf = job["msdf"].clone().requires_grad_(True)
    mesh = ext(job["pos"], sdf, msdf, shard_group=dist.group.WORLD)
    loss = (mesh.verts ** 2 * job["wv"]).sum() + (mesh.msdf * job["wm"]).sum() + mesh.msdf_boundary.sum()
    loss.backward()
    return {"verts": mesh.verts.detach(), "faces": mesh.faces, "face_valid": mesh.face_valid,
            "msdf": mesh.msdf.detach(), "edge_sdf": mesh.edge_sdf.detach(), "n_valid_tets": mesh.n_valid_tets,
            "g_sdf": sdf.grad, "g_msdf": msdf.grad}
