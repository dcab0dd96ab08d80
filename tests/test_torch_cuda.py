"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has a GPU and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Without a CUDA device every test skips.  Tolerances: stage B is compared
bit for bit (ids everywhere, z where hit): the kernel rounds its edge and
depth arithmetic like PyTorch's eager ops (no FMA contraction), and merges
the sub-segments of crowded tiles exactly.  The bilateral stencil to rtol
1e-5 / atol 1e-6: the same taps in the same order, but the kernel's expf and
the fused sums may round an ulp apart.
"""
import math

import pytest
import torch

from gshell_tpu_torch.ops import denoiser as dn
from gshell_tpu_torch.ops import rasterize as rz
from gshell_tpu_torch.ops.math import lookat, perspective, xfm_points
from gshell_tpu_torch.utils.synthetic import crowded_tile_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on a GPU")
    return torch.device("cuda:0")


def _v_clip(n_verts, seed, device):
    g = torch.Generator().manual_seed(seed)
    verts = torch.rand((n_verts, 3), generator=g) * 1.2 - 0.6
    mvp = perspective(math.radians(45.0)) @ lookat([0.0, 0.0, 2.2], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return xfm_points(verts, mvp).to(device), g


@pytest.mark.parametrize("res, n_faces, seed", [(64, 200, 0), (512, 6000, 1)])
def test_stage_b_kernel_matches_plain(dev, res, n_faces, seed):
    v_clip, g = _v_clip(n_faces // 2, seed, dev)
    faces = torch.randint(0, n_faces // 2, (n_faces, 3), generator=g).to(dev)
    bins = rz.bin_pairs(v_clip, faces, (res, res))
    args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    before = rz.stage_b_calls
    kz, kid = rz.rasterize_stage_b(*args)
    torch.cuda.synchronize()
    assert rz.stage_b_calls == before + 1
    pz, pid = rz.stage_b_plain(*args)
    hit = pid >= 0
    assert int(hit.sum()) > 0
    assert torch.equal(kid, pid)
    assert torch.equal(kz[hit], pz[hit])


@pytest.mark.parametrize("res, seed", [(64, 0), (512, 1)])
def test_stage_b_kernel_merges_crowded_tiles_exactly(dev, res, seed):
    """One tile with several sub-segments, exact depth ties across them
    (duplicated triangles) and a +0.0 sheet whose -0.0 duplicate comes
    last: ids and hit depths identical to the plain version."""
    v_clip, faces = crowded_tile_mesh(res, seed=seed)
    bins = rz.bin_pairs(v_clip.to(dev), faces.to(dev), (res, res))
    assert int(bins.tile_cnt.max()) >= 4 * rz.STAGE_B_SUB
    args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    kz, kid = rz.rasterize_stage_b(*args)
    torch.cuda.synchronize()
    pz, pid = rz.stage_b_plain(*args)
    hit = pid >= 0
    assert bool(hit.all())
    assert torch.equal(kid, pid)
    assert torch.equal(kz[hit], pz[hit])
    assert int((kid >= faces.shape[0] - 2).sum()) == 0  # never the -0.0 duplicate


def test_stage_b_wrapper_rejects_bad_arguments(dev):
    v_clip, g = _v_clip(50, 2, dev)
    faces = torch.randint(0, 50, (100, 3), generator=g).to(dev)
    bins = rz.bin_pairs(v_clip, faces, (64, 64))
    with pytest.raises(ValueError):
        rz.rasterize_stage_b(bins.pair_data.double(), bins.tile_start, bins.tile_cnt,
                             bins.n_tiles, bins.tx_n)
    with pytest.raises(ValueError):
        rz.rasterize_stage_b(bins.pair_data, bins.tile_start.long(), bins.tile_cnt,
                             bins.n_tiles, bins.tx_n)
    with pytest.raises(ValueError):
        rz.rasterize_stage_b(bins.pair_data.t().contiguous().t(), bins.tile_start, bins.tile_cnt,
                             bins.n_tiles, bins.tx_n)


def _stencil_inputs(h, w, seed, device):
    g = torch.Generator().manual_seed(seed)
    col = torch.rand((h, w, 3), generator=g)
    nrm = torch.nn.functional.normalize(torch.randn((h, w, 3), generator=g), dim=-1)
    # smooth normals and depth, as a rendered surface gives them
    nrm = torch.nn.functional.normalize(nrm + 4.0 * torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    z = torch.rand((h, w, 1), generator=g) * 0.1 + 1.0
    dz = torch.rand((h, w, 1), generator=g) * 0.05 + 0.01
    return [t.to(device).contiguous() for t in (col, nrm, torch.cat([z, dz], -1))]


@pytest.mark.parametrize("channels", [3, 6])
@pytest.mark.parametrize("h, w, r", [(37, 53, 5), (512, 512, 11)])
@pytest.mark.parametrize("from_tap", [False, True])
def test_bilateral_kernel_matches_plain(dev, h, w, r, from_tap, channels):
    col, nrm, zdz = _stencil_inputs(h, w, 3, dev)
    if channels == 6:
        col = torch.cat([col, 1.0 - 2.0 * col.flip(0)], -1).contiguous()
    before = dn.bilateral_launches
    kc, kw = dn.bilateral_accumulate(col, nrm, zdz, 2.0, r, denom_from_tap=from_tap)
    torch.cuda.synchronize()
    assert dn.bilateral_launches == before + 1
    pc, pw = dn.bilateral_plain(col, nrm, zdz, 2.0, r, denom_from_tap=from_tap)
    torch.testing.assert_close(kc, pc, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kw, pw, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("from_tap", [False, True])
def test_bilateral_kernel_six_channels_equal_two_three_channel_launches(dev, from_tap):
    col, nrm, zdz = _stencil_inputs(96, 80, 6, dev)
    col2 = (col * 3.0 - 1.0).flip(1).contiguous()
    c6, w6 = dn.bilateral_accumulate(torch.cat([col, col2], -1).contiguous(), nrm, zdz, 2.0, 11,
                                     denom_from_tap=from_tap)
    a, wa = dn.bilateral_accumulate(col, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
    b, _ = dn.bilateral_accumulate(col2, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
    torch.cuda.synchronize()
    assert torch.equal(c6, torch.cat([a, b], -1))
    assert torch.equal(w6, wa)


_EXPF_TINY = r"""
#include <cuda_runtime.h>
__global__ void count(unsigned n, unsigned* bad) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    if (expf(-__int_as_float((int)i)) != 1.f) atomicAdd(bad, 1u);
}
extern "C" int run(unsigned n, void* bad) {
  count<<<1024, 256>>>(n, (unsigned*)bad);
  return (int)cudaDeviceSynchronize();
}
"""


def test_expf_of_every_tiny_argument_is_one(dev, tmp_path):
    """bilateral.cu adds 1e-30 to |z_t - z_c| to keep the division on its
    fast path; that is exact because the quotient then changes only where
    both quotients are <= 2.3e-16, and expf(-v) == 1 for every float v in
    [0, 1e-15], compiled with the kernels' own flags."""
    import ctypes
    import struct
    import subprocess

    from gshell_tpu_torch.utils import kernels

    src, so = tmp_path / "expf_tiny.cu", tmp_path / "expf_tiny.so"
    src.write_text(_EXPF_TINY)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_uint, ctypes.c_void_p]
    n = struct.unpack("<I", struct.pack("<f", 1e-15))[0] + 1
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    assert lib.run(n, ctypes.c_void_p(bad.data_ptr())) == 0
    assert int(bad) == 0


def test_bilateral_kernel_matches_plain_on_background(dev):
    """Guides that are 0 outside a disk, as a rendered view's are: most taps
    have z_t = z_c = 0."""
    col, nrm, zdz = _stencil_inputs(160, 192, 7, dev)
    ys, xs = torch.meshgrid(torch.arange(160, device=dev), torch.arange(192, device=dev), indexing="ij")
    mask = (((xs - 96.0) ** 2 + (ys - 80.0) ** 2) < 50.0 ** 2).float()[..., None]
    col6 = (torch.cat([col, col.flip(1)], -1) * mask).contiguous()
    nrm, zdz = (nrm * mask).contiguous(), (zdz * mask).contiguous()
    for from_tap in (False, True):
        kc, kw = dn.bilateral_accumulate(col6, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
        pc, pw = dn.bilateral_plain(col6, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
        torch.cuda.synchronize()
        assert torch.equal(kc, pc) and torch.equal(kw, pw)


@pytest.mark.parametrize("from_tap", [False, True])
def test_bilateral_kernel_propagates_nonfinite_depth(dev, from_tap):
    """A NaN or inf z, at the border and inside, gives NaN and inf where the
    plain version gives them (a non-finite depth must reach the loss)."""
    col, nrm, zdz = _stencil_inputs(64, 80, 8, dev)
    col6 = torch.cat([col, col.flip(0)], -1).contiguous()
    zdz = zdz.clone()
    zdz[0, 3, 0] = float("nan")
    zdz[30, 40, 0] = float("nan")
    zdz[50, 79, 0] = float("inf")
    zdz[20, 10, 0] = float("-inf")
    kc, kw = dn.bilateral_accumulate(col6, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
    pc, pw = dn.bilateral_plain(col6, nrm, zdz, 2.0, 11, denom_from_tap=from_tap)
    torch.cuda.synchronize()
    assert bool(pw.isnan().any()) and bool(pw.isfinite().any())
    torch.testing.assert_close(kc, pc, rtol=1e-5, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(kw, pw, rtol=1e-5, atol=1e-6, equal_nan=True)


def test_denoiser_autograd_on_the_card_matches_the_cpu(dev):
    """Value and colour gradient of the autograd denoiser: the CUDA path
    (forward and transposed kernels) against the CPU path (plain stencils)."""
    col, nrm, zdz = _stencil_inputs(48, 64, 4, "cpu")
    g = torch.randn((48, 64, 3), generator=torch.Generator().manual_seed(5))
    outs = {}
    for d in ("cpu", dev):
        c = col.detach().clone().to(d).requires_grad_(True)
        out = dn.bilateral_denoiser(c, nrm.to(d), zdz.to(d), 2.0, 5)
        out.backward(g.to(d))
        outs[str(d)] = (out.detach().cpu(), c.grad.cpu())
    (vc, gc), (vk, gk) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(vk, vc, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gk, gc, rtol=1e-5, atol=1e-5)


def test_train_step_on_the_card_runs_through_both_kernels(dev):
    """A tiny reconstruction step on the card: finite losses, a surface, and
    one stage-B call and two denoiser launches (forward and backward, both
    colours in one) per view."""
    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.geometry.mlp import MLPConfig
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max
    from gshell_tpu_torch.render.render import RenderFlags
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
    from gshell_tpu_torch.utils.rng import TorchDraws

    res, batch = 64, 2
    geo = GShellGeometry(GeometryConfig(grid_res=16, n_eikonal_samples=512,
                                        mlp=MLPConfig(n_freq=4, d_hidden=64, n_hidden=2, skip_in=(1,))), dev)
    mat = MLPTexture3DConfig(hash=HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                                                 desired_resolution=64),
                             internal_dims=16, min_max=default_kd_ks_min_max())
    flags = RenderFlags(resolution=(res, res), n_samples=2, shade_budget=0.5, mc_block=2)
    rec = Reconstructor(geo, mat, flags, TrainConfig(batch=batch))
    draws = TorchDraws(torch.Generator(dev).manual_seed(0))
    state = rec.init_state(draws.child("init"), pretrain_steps=300)
    state.step = 1000
    mvp = perspective(math.radians(45.0)) @ lookat([0.0, 0.0, 2.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    ys, xs = torch.meshgrid(torch.arange(res), torch.arange(res), indexing="ij")
    disk = ((xs - res / 2) ** 2 + (ys - res / 2) ** 2 < (0.3 * res) ** 2).float()[None, ..., None]
    target = {k: v.to(dev) for k, v in {
        "mvp": mvp[None].repeat(batch, 1, 1), "campos": torch.tensor([[0.0, 0.0, 2.5]]).repeat(batch, 1),
        "img": torch.cat([0.5 * disk.repeat(batch, 1, 1, 3), disk.repeat(batch, 1, 1, 1)], -1),
        "background": torch.zeros((batch, res, res, 3)),
    }.items()}
    sb, bl = rz.stage_b_calls, dn.bilateral_launches
    m = rec.train_step(state, draws.child("step"), target)
    torch.cuda.synchronize()
    assert rz.stage_b_calls - sb == batch
    assert dn.bilateral_launches - bl == 2 * batch
    assert int(m["n_faces"]) > 0 and int(m["raster_dropped"]) == 0
    for k in ("total", "img_loss", "reg_loss"):
        assert math.isfinite(float(m[k])), k


def test_flexicubes_extraction_on_the_card_matches_the_cpu(dev):
    """The FlexiCubes extractor at voxel 80 (531,441 lattice vertices, the
    default 102,400 cube and 76,800 edge slots) on the card against the CPU,
    on the same fields and random per-cube weights: faces equal, vertices and
    the mSDF of the rows a valid face reads to 1e-5."""
    from gshell_tpu_torch.geometry.cube_grid import build_cube_grid
    from gshell_tpu_torch.geometry.gshell_flexicubes import GShellFlexiCubes

    grid = build_cube_grid(80)
    g = torch.Generator().manual_seed(0)
    x = torch.as_tensor(grid.verts) * 1.4 + (torch.rand(grid.verts.shape, generator=g) - 0.5) * 0.005
    s = torch.linalg.norm(x, dim=-1) - 0.45 + 0.03 * torch.sin(7.0 * x[:, 0])
    nu = 0.2 - x[:, 1] + 0.3 * x[:, 2]
    w = torch.randn((grid.n_cubes, 21), generator=g) * 0.5
    out = {}
    for d in ("cpu", dev):
        ext = GShellFlexiCubes(grid, d)
        wd = w.to(d)
        m = ext(x.to(d), s.to(d), nu.to(d), beta=wd[:, :12], alpha=wd[:, 12:20], gamma=wd[:, 20])
        out[str(d)] = {k: getattr(m, k).cpu() for k in ("faces", "face_valid", "verts", "msdf", "l_dev")}
        out[str(d)].update(n_surf=int(m.n_surf_cubes), n_quad=int(m.n_quad_edges), n_wt=m.n_verts_watertight)
    c, k = out["cpu"], out[str(dev)]
    assert 0 < c["n_surf"] <= 102_400 and 0 < c["n_quad"] <= 76_800
    assert (k["n_surf"], k["n_quad"]) == (c["n_surf"], c["n_quad"])
    assert torch.equal(k["faces"], c["faces"]) and torch.equal(k["face_valid"], c["face_valid"])
    used = torch.zeros(c["verts"].shape[0], dtype=torch.bool)
    used[: c["n_wt"]] = True
    used[c["faces"][c["face_valid"]].reshape(-1)] = True
    torch.testing.assert_close(k["verts"][used], c["verts"][used], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k["msdf"][used], c["msdf"][used], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(k["l_dev"], c["l_dev"], rtol=1e-5, atol=0.0)
