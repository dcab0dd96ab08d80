"""The port's process-group pieces (``gshell_tpu_torch/parallel/``,
``data/multihost.py``, the extractor's shard group) against the JAX
package's mesh versions, on the CPU.

* ``band_mvp`` against JAX's to 1e-6.
* ``fsdp_placements`` against ``fsdp_sharding``'s ``PartitionSpec``s for
  the same shapes on the 8-device CPU mesh.
* ``DistributedGridSampler``: each rank's rows for W = 2 and 4 equal the
  rows of JAX's addressable shards on a W-device mesh, bit for bit, and the
  rank opens only the files behind them.
* On two gloo ranks (``tests/torch_dist.py``): the data and (dcn × data)
  meshes and their groups, the stitch's value and gradient,
  ``pixel_sharded_shade`` against the unsharded call (its mean under the
  furnace condition, as JAX's test holds it), and the sharded
  extraction against the replicated one: every output equal bit for bit,
  the ranks' averaged field gradients to 1e-6 of their norm (the slots'
  contributions summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.data.multihost import DistributedGridSampler as JSampler
from gshell_tpu.parallel.sharding import fsdp_sharding, make_mesh
from gshell_tpu.parallel.spatial import band_mvp as j_band_mvp
from gshell_tpu_torch.data import grids
from gshell_tpu_torch.data.multihost import DistributedGridSampler
from gshell_tpu_torch.geometry.gshell_tets import GShellTets
from gshell_tpu_torch.geometry.tet_grid import build_tet_grid
from gshell_tpu_torch.ops.shade import env_shade
from gshell_tpu_torch.parallel.sharding import batch_rows, fsdp_placements, slot_range
from gshell_tpu_torch.parallel.spatial import band_mvp
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.utils.rng import TorchDraws
from torch_dist import run_ranks

torch.set_num_threads(1)


@pytest.mark.parametrize("y0, h_band, h_full", [(-16, 160, 512), (368, 160, 512), (496, 544, 1024), (16, 48, 64)])
def test_band_mvp_matches_jax(y0, h_band, h_full):
    mvp = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    want = np.asarray(j_band_mvp(jnp.asarray(mvp), jnp.float32(y0), h_band, h_full))
    got = band_mvp(torch.from_numpy(mvp), y0, h_band, h_full).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fsdp_placements_match_jax_partition_specs():
    shapes = {"big": (1024, 256), "tall": (256, 1024), "small": (8, 8), "odd": (1023, 131),
              "conv": (3, 3, 3, 128, 256), "ties": (512, 512), "scalar": (), "vec": (2 ** 17,)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    want = fsdp_sharding(make_mesh(8), {k: jnp.asarray(v) for k, v in params.items()}, min_size=1024)
    got = fsdp_placements({k: torch.from_numpy(v) for k, v in params.items()}, 8, min_size=1024)
    for k in shapes:
        spec = tuple(want[k].spec)
        axes = [i for i, a in enumerate(spec) if a == "data"]
        if axes:
            assert got[k].is_shard(axes[0]), (k, spec, got[k])
        else:
            assert got[k].is_replicate(), (k, spec, got[k])


@pytest.fixture(scope="module")
def grid_files(tmp_path_factory):
    d, rng = tmp_path_factory.mktemp("grids"), np.random.default_rng(0)
    files = []
    for i in range(6):
        f = d / f"g{i}.npz"
        np.savez(f, grid=rng.normal(size=(4, 4, 4, 2)).astype(np.float32),
                 occgrid=rng.normal(size=(8, 8, 8)).astype(np.float32))
        files.append(str(f))
    return files


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_grid_sampler_rows_match_jax_shards(grid_files, world, monkeypatch):
    acc, b, seed = 2, 8, 7
    jbatch = JSampler(grid_files, make_mesh(world), 4, acc, b, seed=seed)()
    shards = {}
    for name in ("grid", "occgrid"):
        for s in jbatch[name].addressable_shards:
            shards.setdefault(s.index[1].start or 0, {})[name] = np.asarray(s.data)
    idx = grids.grid_indices(seed, 0, len(grid_files), acc * b).reshape(acc, b)
    plain_load = np.load
    for rank in range(world):
        opened = []
        monkeypatch.setattr(np, "load", lambda f, *a, **k: (opened.append(str(f)), plain_load(f, *a, **k))[1])
        got = DistributedGridSampler(grid_files, acc, b, rank, world, seed=seed)()
        monkeypatch.setattr(np, "load", plain_load)
        rows = batch_rows(b, rank, world)
        want = shards[rows.start]
        assert got["grid"].shape == (acc, b // world, 2, 4, 4, 4)
        np.testing.assert_array_equal(np.moveaxis(got["grid"].numpy(), 2, -1), want["grid"])
        np.testing.assert_array_equal(np.moveaxis(got["occgrid"].numpy(), 2, -1), want["occgrid"])
        assert sorted(set(opened)) == sorted({grid_files[i] for i in idx[:, rows].reshape(-1)})


def test_distributed_grid_sampler_rejects_an_uneven_split(grid_files):
    with pytest.raises(ValueError, match="does not split"):
        DistributedGridSampler(grid_files, 2, 6, 0, 4)


def _shade_inputs(p=64):
    light = torch.ones((16, 32, 3))
    nrm = torch.tensor([[0.0, 0.0, 1.0]]).repeat(p, 1)
    ks = torch.stack([torch.zeros(p), torch.full((p,), 0.5), torch.zeros(p)], -1)
    return {"light": light, "mask": torch.ones((p, 1)), "pos": torch.zeros((p, 3)), "nrm": nrm,
            "view": torch.tensor([[0.0, 0.0, 2.0]]).repeat(p, 1), "kd": torch.full((p, 3), 0.5), "ks": ks}


def test_meshes_stitch_and_pixel_sharded_shade_on_two_ranks(tmp_path):
    s = _shade_inputs()
    outs = run_ranks("stitch_and_shade", 2, {"shade": s}, tmp_path)
    ref = env_shade(TorchDraws(torch.Generator().manual_seed(0)), s["mask"], s["pos"], s["pos"], s["nrm"],
                    s["view"], s["kd"], s["ks"], update_pdf(s["light"]), n_samples_x=2, bsdf="diffuse",
                    shadow_scale=0.0)
    for r, o in enumerate(outs):
        assert o["meshes"] == {"data": ((2,), ("data",), (r, 2)), "dcn_data": ((2, 1), ("dcn", "data"), (r, 2))}
        assert torch.equal(o["whole"], torch.arange(8.0))
        # each rank's pieces get W x their gradient; the trainer's average restores it
        want = torch.zeros(8)
        want[r * 4:(r + 1) * 4] = 2.0 * torch.arange(8.0)[r * 4:(r + 1) * 4]
        assert torch.equal(o["grad"], want)
        assert o["diffuse"].shape == ref.diffuse.shape
        np.testing.assert_allclose(float(o["diffuse"].mean()), float(ref.diffuse.mean()), rtol=0.1)
    assert torch.equal(outs[0]["diffuse"], outs[1]["diffuse"])


def _extraction_job(res=16):
    grid = build_tet_grid(res, build_topology=False)
    rng = np.random.default_rng(1)
    pos = torch.from_numpy((grid.verts + rng.uniform(-0.01, 0.01, size=grid.verts.shape)).astype(np.float32))
    sdf = 0.35 - torch.linalg.norm(pos, dim=-1)
    msdf = torch.sin(6.0 * pos[:, 1])
    ext = GShellTets(grid, "cpu")
    n_out = ext.max_verts + 1 + 4 * ext.max_tets
    return {"res": res, "pos": pos, "sdf": sdf, "msdf": msdf,
            "wv": torch.from_numpy(rng.normal(size=(n_out, 3)).astype(np.float32)),
            "wm": torch.from_numpy(rng.normal(size=(n_out,)).astype(np.float32))}


def test_sharded_extraction_matches_the_replicated_one(tmp_path):
    job = _extraction_job()
    outs = run_ranks("sharded_extraction", 2, job, tmp_path)
    ext = GShellTets(build_tet_grid(job["res"], build_topology=False), "cpu")
    sdf, msdf = job["sdf"].clone().requires_grad_(True), job["msdf"].clone().requires_grad_(True)
    mesh = ext(job["pos"], sdf, msdf)
    ((mesh.verts ** 2 * job["wv"]).sum() + (mesh.msdf * job["wm"]).sum() + mesh.msdf_boundary.sum()).backward()
    assert int(mesh.face_valid.sum()) > 0 and int((mesh.msdf_boundary != 0).sum()) > 0
    for o in outs:
        for k in ("verts", "faces", "face_valid", "msdf", "edge_sdf", "n_valid_tets"):
            assert torch.equal(o[k], getattr(mesh, k).detach()), k
    for k, want in (("g_sdf", sdf.grad), ("g_msdf", msdf.grad)):
        got = (outs[0][k] + outs[1][k]) / 2
        assert float((got - want).norm() / want.norm()) <= 1e-6, k


@pytest.mark.parametrize("n, world", [(10, 2), (10, 3), (7, 4), (3, 4)])
def test_slot_ranges_cover_every_slot_once(n, world):
    ranges = [slot_range(n, r, world) for r in range(world)]
    assert [i for lo, hi in ranges for i in range(lo, hi)] == list(range(n))
