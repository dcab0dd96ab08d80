"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has a GPU and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Without a CUDA device every test skips.  Tolerances: stage B is compared
bit for bit (ids everywhere, z where hit): the kernel rounds its edge and
depth arithmetic like PyTorch's eager ops (no FMA contraction), and merges
the sub-segments of crowded tiles exactly.  Against the scan oracle
(``rasterize_peel``) the kernel's layer and the binned second layer may
pick another triangle only where the two candidates' depths tie within
1e-6 (stage B's depth is depth_num·(1/area), the scan's Σ (e_k/area)·z_k).
The bilateral stencil to rtol 1e-5 / atol 1e-6: the same taps in the same
order, but the kernel's expf and the fused sums may round an ulp apart.
The template-SDF marcher (plain PyTorch, no hand kernel) on the card against
the CPU: nearest exactly, trilinear on at most 1e-4 of the rays (each
sample is eager elementwise arithmetic on both sides, so none is expected).
The gathers' backward (``csrc/gather_rows.cu``) against aten's
``index_put_(accumulate=True)``, the backward of ``src[idx]``: the same
numbers summed in f32 in another order, so each row within 1e-6 of the
norm of its summed magnitudes (the scale of either sum's rounding), NaN
and infinities in the same places, bf16 within one bf16 unit more;
every zero gradient row skipped, by the kernel's own count.
"""
import math

import pytest
import torch

from gshell_tpu_torch.ops import denoiser as dn
from gshell_tpu_torch.ops import gather as ga
from gshell_tpu_torch.ops import rasterize as rz
from gshell_tpu_torch.ops.math import lookat, perspective, xfm_points
from gshell_tpu_torch.utils.kernels import kernel_launches
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
    before = kernel_launches()["rasterize_stage_b"]
    kz, kid = rz.rasterize_stage_b(*args)
    torch.cuda.synchronize()
    assert kernel_launches()["rasterize_stage_b"] == before + 1
    pz, pid = rz.stage_b_plain(*args)
    hit = pid >= 0
    assert int(hit.sum()) > 0
    assert torch.equal(kid, pid)
    assert torch.equal(kz[hit], pz[hit])


@pytest.mark.parametrize("h, w, n_band, band", [(512, 512, 4, 0), (512, 512, 4, 2), (1024, 1024, 2, 1)])
def test_stage_b_kernel_matches_plain_on_a_band(dev, h, w, n_band, band):
    """A band of the banded render (``parallel.spatial``): rows
    [b·h/n − 16, (b+1)·h/n + 16) of an h×w view through ``band_mvp``, a tile
    grid of other height than width (160 × 512 and 544 × 1024)."""
    from gshell_tpu_torch.parallel.spatial import band_mvp

    g = torch.Generator().manual_seed(band)
    verts = torch.rand((3000, 3), generator=g) * 1.2 - 0.6
    faces = torch.randint(0, 3000, (6000, 3), generator=g).to(dev)
    mvp = perspective(math.radians(45.0)) @ lookat([0.0, 0.0, 2.2], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    hb = h // n_band + 32
    v_clip = xfm_points(verts, band_mvp(mvp, band * (h // n_band) - 16, hb, h)).to(dev)
    bins = rz.bin_pairs(v_clip, faces, (hb, w))
    assert (bins.ty_n, bins.tx_n) == (hb // rz.TILE, w // rz.TILE)
    args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    kz, kid = rz.rasterize_stage_b(*args)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("h, w, r", [(37, 53, 5), (512, 512, 11), (160, 512, 11), (544, 1024, 11)])
@pytest.mark.parametrize("from_tap", [False, True])
def test_bilateral_kernel_matches_plain(dev, h, w, r, from_tap, channels):
    col, nrm, zdz = _stencil_inputs(h, w, 3, dev)
    if channels == 6:
        col = torch.cat([col, 1.0 - 2.0 * col.flip(0)], -1).contiguous()
    before = kernel_launches()["bilateral_accumulate"]
    kc, kw = dn.bilateral_accumulate(col, nrm, zdz, 2.0, r, denom_from_tap=from_tap)
    torch.cuda.synchronize()
    assert kernel_launches()["bilateral_accumulate"] == before + 1
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
    """A tiny reconstruction step on the card with every view's residuals
    kept (``map``): finite losses, a surface, and one stage-B call and two
    denoiser launches (forward and backward, both colours in one) per
    view."""
    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.geometry.mlp import MLPConfig
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max
    from gshell_tpu_torch.render.render import RenderFlags
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
    from gshell_tpu_torch.utils.rng import TorchDraws

    res, batch = 64, 2
    geo = GShellGeometry(GeometryConfig(grid_res=16, n_eikonal_samples=512, view_batch_mode="map",
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
    sb, bl, gb = (kernel_launches()[k] for k in ("rasterize_stage_b", "bilateral_accumulate", "gather_rows"))
    m = rec.train_step(state, draws.child("step"), target)
    torch.cuda.synchronize()
    assert kernel_launches()["rasterize_stage_b"] - sb == batch
    assert kernel_launches()["bilateral_accumulate"] - bl == 2 * batch
    assert kernel_launches()["gather_rows"] > gb
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


def _skirt_view(res, dev):
    from gshell_tpu_torch.utils.synthetic_gt import skirt

    v, f = skirt()
    mvp = perspective(math.radians(45.0)) @ lookat([0.4, 0.9, 2.6], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return xfm_points(torch.as_tensor(v) * 0.8, mvp).to(dev), torch.as_tensor(f).long().to(dev)


@pytest.mark.parametrize("mesh", ["skirt", "crowded"])
def test_stage_b_kernel_and_binned_second_layer_match_the_scan(dev, mesh):
    """At 512²: the stage-B kernel's raster and the binned two layers
    (``rasterize_tiled_peel``: one kernel launch, then the second layer
    given its winners) against the scan oracle's first two layers on
    the skirt (12,288 faces, both sides in view) and on the crowded tile
    (exact depth ties between distinct triangles, which the two depth
    roundings order either way); the second layer is not empty."""
    res = 512
    v_clip, faces = _skirt_view(res, dev) if mesh == "skirt" else (t.to(dev) for t in crowded_tile_mesh(res))
    scan = rz.rasterize_peel(v_clip, faces, (res, res), n_layers=2)
    before = kernel_launches()["rasterize_stage_b"]
    kernel = rz.rasterize_tiled(v_clip, faces, (res, res))
    torch.cuda.synchronize()
    assert kernel_launches()["rasterize_stage_b"] == before + 1
    binned = rz.rasterize_tiled_peel(v_clip, faces, (res, res))
    torch.cuda.synchronize()
    assert kernel_launches()["rasterize_stage_b"] == before + 2
    assert int((scan[1].tri_id > 0).sum()) > 1000
    for what, a, b in (("kernel", kernel, scan[0]), ("binned 1", binned[0], scan[0]), ("binned 2", binned[1], scan[1])):
        d = rz.layer_differences(a, b, v_clip, faces, tol=1e-6)
        assert d["unexplained"] == 0, (what, d)
    assert torch.equal(binned[0].tri_id, kernel.tri_id)


def test_map_remat_matches_map_on_the_card(dev):
    """The tets tick with the second layer and depth on, at 64², batch 2,
    under ``map`` and ``map_remat`` from the same generator state: the
    losses and every gradient agree (the card's atomics sum in another
    order when a view is recomputed: rtol 1e-5 on the losses, cosine ≥
    0.99999 per parameter), the generator ends in the same state, and the
    recomputation launches stage B and the forward stencil once more per
    view."""
    from gshell_tpu_torch.geometry.geometry import GeometryConfig, GShellGeometry
    from gshell_tpu_torch.geometry.mlp import MLPConfig
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max
    from gshell_tpu_torch.render.render import RenderFlags
    from gshell_tpu_torch.train.reconstruct import Reconstructor, TrainConfig
    from gshell_tpu_torch.utils.rng import TorchDraws

    res, batch = 64, 2
    mvp = perspective(math.radians(45.0)) @ lookat([0.0, 0.5, 2.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    ys, xs = torch.meshgrid(torch.arange(res), torch.arange(res), indexing="ij")
    r2 = (xs - res / 2) ** 2 + (ys - res / 2) ** 2
    disk = (r2 < (0.3 * res) ** 2).float()[None, ..., None].repeat(batch, 1, 1, 1)
    inner = (r2 < (0.2 * res) ** 2).float()[None, ..., None].repeat(batch, 1, 1, 1)
    target = {k: v.to(dev) for k, v in {
        "mvp": mvp[None].repeat(batch, 1, 1), "campos": torch.tensor([[0.0, 0.5, 2.5]]).repeat(batch, 1),
        "img": torch.cat([0.5 * disk.repeat(1, 1, 1, 3), disk], -1), "background": torch.zeros((batch, res, res, 3)),
        "invdepth": 0.4 * disk, "img_second": torch.cat([0.3 * inner.repeat(1, 1, 1, 3), inner], -1),
        "invdepth_second": 0.35 * inner}.items()}
    out = {}
    for mode in ("map", "map_remat"):
        geo = GShellGeometry(GeometryConfig(grid_res=16, n_eikonal_samples=512, view_batch_mode=mode, use_depth=True,
                                            use_img_2nd_layer=True, use_depth_2nd_layer=True,
                                            mlp=MLPConfig(n_freq=4, d_hidden=64, n_hidden=2, skip_in=(1,))), dev)
        mat = MLPTexture3DConfig(hash=HashGridConfig(n_levels=4, log2_table_size=12, base_resolution=4,
                                                     desired_resolution=64),
                                 internal_dims=16, min_max=default_kd_ks_min_max())
        rec = Reconstructor(geo, mat, RenderFlags(resolution=(res, res), n_samples=2, shade_budget=0.5, mc_block=2),
                            TrainConfig(batch=batch))
        state = rec.init_state(TorchDraws(torch.Generator(dev).manual_seed(0)), pretrain_steps=300)
        gen = torch.Generator(dev).manual_seed(1)
        sb, bl = kernel_launches()["rasterize_stage_b"], kernel_launches()["bilateral_accumulate"]
        img, depth, reg, _ = geo.tick(TorchDraws(gen), state.params_geo, state.params_mat, mat,
                                      update_pdf(state.light_base), target, 1000, rec.flags, rec.image_loss_fn,
                                      shadow_scale=1.0, denoiser_sigma=2.0)
        (img + depth + reg).backward()
        torch.cuda.synchronize()
        leaves = [p for o in state.optimizers for g in o.param_groups for p in g["params"]]
        out[mode] = ([float(x.detach()) for x in (img, depth, reg)], [p.grad.detach().clone() for p in leaves],
                     gen.get_state(), kernel_launches()["rasterize_stage_b"] - sb,
                     kernel_launches()["bilateral_accumulate"] - bl)
    (la, ga, sa, sba, bla), (lb, gb, sbb_state, sbb, blb) = out["map"], out["map_remat"]
    assert la[1] > 0 and all(math.isfinite(x) for x in la)
    for a, b in zip(la, lb):
        assert b == pytest.approx(a, rel=1e-5)
    for a, b in zip(ga, gb):
        cos = torch.nn.functional.cosine_similarity(a.reshape(1, -1).double(), b.reshape(1, -1).double()).item()
        assert cos >= 0.99999 or (a.abs().max() == 0 and b.abs().max() == 0), cos
    assert torch.equal(sa, sbb_state)
    assert (sba, bla) == (batch, 2 * batch) and (sbb, blb) == (2 * batch, 3 * batch)


def _named_draws(device):
    """Draws that depend only on their names, the same numbers on any
    device: each name seeds its own numpy generator."""
    import zlib

    import numpy as np

    from gshell_tpu_torch.utils.rng import ReplayDraws

    def source(kind, name, shape, lo, hi):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        if kind == "uniform":
            return rng.uniform(lo, hi, size=shape).astype(np.float32)
        if kind == "normal":
            return rng.normal(size=shape).astype(np.float32)
        return rng.integers(lo, hi, size=shape)

    return ReplayDraws(source, device)


def test_texture2d_render_on_the_card_matches_the_cpu(dev):
    """A Texture2D material (kd with alpha, ks, a normal map) rendered at 64²
    with spp 2 (128² rasters) and denoising after modulation, on the card
    and on the CPU from the same named draws: under ``kd`` the buffers to
    rtol 1e-5 / atol 1e-5 and the gradients to every mip level to rtol 1e-4
    / atol 1e-5 of the largest (index accumulation in another order); under
    ``pbr`` one stage-B call and one 3-channel stencil launch on the card,
    and the shaded image within 2e-3 mean |diff| (an MC sample may flip on
    the card's rounding)."""
    import numpy as np

    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.render.material import TextureMaterial
    from gshell_tpu_torch.render.render import RenderFlags, render_mesh
    from gshell_tpu_torch.render.texture import Texture2D, build_mips
    from gshell_tpu_torch.utils.synthetic_gt import sphere

    v, f = sphere(24, 16)
    v = torch.as_tensor(v * 0.8)
    unit = v / v.norm(dim=-1, keepdim=True)
    uv = torch.stack([0.5 + torch.atan2(unit[:, 0], unit[:, 2]) / (2 * math.pi),
                      torch.arccos(unit[:, 1].clamp(-1, 1)) / math.pi], -1)
    yx = torch.stack(torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij"), -1) / 32.0
    wave = lambda a, b, c: 0.5 + 0.45 * torch.sin(2 * math.pi * (a * yx[..., 0] + b * yx[..., 1]) + c)
    maps = {"kd": torch.stack([wave(1, 2, 0), wave(2, 1, 1), wave(3, 1, 2), 0.8 + 0.2 * wave(1, 1, 3)], -1),
            "ks": torch.stack([torch.zeros(32, 32), 0.4 + 0.5 * wave(1, 3, 4), wave(2, 2, 5)], -1),
            "normal": torch.stack([0.4 + 0.2 * wave(2, 3, 6), 0.4 + 0.2 * wave(3, 2, 7), torch.ones(32, 32)], -1)}
    light_base = torch.as_tensor(np.random.default_rng(0).uniform(0.25, 0.75, size=(32, 64, 3)).astype(np.float32))
    eye = torch.tensor([0.3, 0.5, 2.2])
    mvp = perspective(math.radians(45.0)) @ lookat(eye, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))
    flags = RenderFlags(resolution=(64, 64), n_samples=2, spp=2, denoiser_demodulate=False, mc_block=2)

    chains = {k: build_mips(m).mips for k, m in maps.items()}

    def render(d, bsdf):  # every mip level its own leaf, as a trainable texture keeps them
        mats = {k: Texture2D(tuple(m.detach().clone().to(d).requires_grad_(True) for m in c))
                for k, c in chains.items()}
        out = render_mesh(_named_draws(d), v.to(d), torch.as_tensor(f).long().to(d), unit.to(d), None,
                          TextureMaterial(**mats), None, mvp.to(d), eye.to(d), update_pdf(light_base.to(d)),
                          flags._replace(bsdf=bsdf), v_tex=uv.to(d), t_tex_idx=torch.as_tensor(f).long().to(d))
        return out, mats

    cpu, cpu_mats = render("cpu", "kd")
    card, card_mats = render(dev, "kd")
    g = torch.randn(cpu["shaded"].shape, generator=torch.Generator().manual_seed(1))
    for out, mats, d in ((cpu, cpu_mats, "cpu"), (card, card_mats, dev)):
        (torch.sum(out["shaded"] * g.to(d)) + out["kd"].sum() + out["ks"].sum()
         + out["perturbed_nrm_grad"].sum()).backward()
    for k in ("shaded", "kd", "ks", "kd_grad", "normal", "perturbed_nrm", "perturbed_nrm_grad", "mask"):
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-5, atol=1e-5, msg=k)
    for name in maps:
        grads = [[torch.zeros_like(m) if m.grad is None else m.grad for m in mats[name].mips]
                 for mats in (card_mats, cpu_mats)]
        assert float(grads[1][0].abs().max()) > 0, name  # the levels this view's footprints reach
        for lvl, (ga, gb) in enumerate(zip(*grads)):
            atol = 1e-5 * max(float(gb.abs().max()), 1e-6)
            torch.testing.assert_close(ga.cpu(), gb, rtol=1e-4, atol=atol, msg=f"{name} level {lvl}")
    sb, bl = kernel_launches()["rasterize_stage_b"], kernel_launches()["bilateral_accumulate"]
    with torch.no_grad():
        pbr_card, _ = render(dev, "pbr")
        torch.cuda.synchronize()
        assert (kernel_launches()["rasterize_stage_b"] - sb, kernel_launches()["bilateral_accumulate"] - bl) == (1, 1)
        pbr_cpu, _ = render("cpu", "pbr")
    assert float((pbr_card["shaded"].cpu() - pbr_cpu["shaded"]).abs().mean()) < 2e-3
    assert "diffuse_light" in pbr_card and "diffuse_light" not in card


@pytest.mark.parametrize("mode", ["nearest", "trilinear"])
def test_sdf_marcher_on_the_card_matches_the_cpu(dev, mode):
    from gshell_tpu_torch.ops.shade import apply_visibility, make_sdf_visibility

    ax = torch.linspace(-0.7, 0.7, 97)
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    grid = 0.35 - torch.sqrt(x * x + y * y + z * z) + 0.05 * torch.sin(9.0 * x)
    g = torch.Generator().manual_seed(0)
    o = torch.rand((1 << 16, 3), generator=g) * 1.6 - 0.8
    d = torch.nn.functional.normalize(torch.randn((1 << 16, 3), generator=g), dim=-1)
    vis = make_sdf_visibility(grid, (-0.7,) * 3, (1.4,) * 3, mode=mode)
    cpu = apply_visibility(vis, o, d)
    card = apply_visibility(vis._replace(grid=vis.grid.to(dev)), o.to(dev), d.to(dev)).cpu()
    assert 0 < float(cpu.mean()) < 1
    n_diff = int((card != cpu).sum())
    assert n_diff == 0 if mode == "nearest" else n_diff <= 1e-4 * o.shape[0], n_diff


def _hold_scatter(g, idx, n):
    """The kernel's scatter of ``g`` (M, C) into ``n`` rows at ``idx`` (M,)
    against aten's on the card; prints the worst row's error over its room
    and over its own norm (``-s`` shows it)."""
    want = torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device).index_put_((idx,), g, accumulate=True)
    scale = torch.zeros((n, g.shape[1]), device=g.device).index_put_(
        (idx,), g.float().abs().nan_to_num(0.0, 0.0, 0.0), accumulate=True)
    live = int((g != 0).any(1).sum())
    before = ga.gather_stats()
    launches = kernel_launches()["gather_rows"]
    got = ga.scatter_rows(g, idx, n)
    after = ga.gather_stats()
    assert kernel_launches()["gather_rows"] == launches + 1
    assert after["rows_seen"] - before["rows_seen"] == g.shape[0]
    assert after["rows_scattered"] - before["rows_scattered"] == live
    assert got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got == float("inf"), want == float("inf"))
    assert torch.equal(got == float("-inf"), want == float("-inf"))
    fin = torch.isfinite(want).all(1)
    err = torch.linalg.vector_norm((got - want)[fin], dim=1)
    room = 1e-6 * torch.linalg.vector_norm(scale[fin], dim=1)
    if g.dtype == torch.bfloat16:  # one more rounding to bf16 of a sum that may differ in its last f32 bits
        room = room + 2.0 ** -7 * torch.linalg.vector_norm(want[fin], dim=1)
    assert bool((err <= room).all()), float((err - room).max())
    norm = torch.linalg.vector_norm(want[fin], dim=1)
    nz = norm > 0
    of_room = float((err / torch.clamp(room, min=1e-30)).max())
    of_norm = float((err[nz] / norm[nz]).max()) if bool(nz.any()) else 0.0
    print(f"scatter {tuple(g.shape)} {g.dtype} into {n} rows: {1 - live / g.shape[0]:.4f} zero rows skipped; "
          f"worst row error {of_room:.3g} of its room, {of_norm:.3g} of its own norm")


def _background_layout(n_faces, n_verts, res, hit_share, seed, dev):
    """A 512² view's face-0 layout: ``1 - hit_share`` of the pixels read face
    0 (the background), the rest a random face; → (faces, fid, hit)."""
    g = torch.Generator().manual_seed(seed)
    faces = torch.randint(0, n_verts, (n_faces, 3), generator=g)
    hit = torch.rand(res * res, generator=g) < hit_share
    fid = torch.where(hit, torch.randint(0, n_faces, (res * res,), generator=g), 0)
    return faces.to(dev), fid.to(dev), hit.to(dev)


@pytest.mark.parametrize("channels", [3, 4, 11])
def test_gather_backward_kernel_matches_aten_on_a_background_layout(dev, channels):
    """``attr[faces[fid]]`` with 65 % of 512² pixels on face 0 and the
    gradient masked there, as ``interpolate`` takes it; a few NaN and
    infinite rows among the hits."""
    faces, fid, hit = _background_layout(60_000, 30_000, 512, 0.35, channels, dev)
    gen = torch.Generator(dev).manual_seed(channels)
    attr = torch.randn((30_000, channels), generator=gen, device=dev, requires_grad=True)
    g = torch.randn((512 * 512, 3, channels), generator=gen, device=dev) * hit[:, None, None]
    hits = torch.nonzero(hit)[:, 0]
    g[hits[0], 1, 0] = float("nan")
    g[hits[1], 2] = float("inf")
    g[hits[2], 0, -1] = float("-inf")
    idx = faces[fid]
    assert torch.equal(ga.gather_rows(attr, idx), attr[idx])
    (got,) = torch.autograd.grad(ga.gather_rows(attr, idx), attr, g)
    (want,) = torch.autograd.grad(attr[idx], attr, g)
    assert torch.equal(got.isnan(), want.isnan())
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    _hold_scatter(g.reshape(-1, channels), idx.reshape(-1), 30_000)


@pytest.mark.parametrize("live_run", [False, True])
def test_gather_backward_kernel_matches_aten_on_a_sentinel_run(dev, live_run):
    """10⁶ padded slots read the sentinel row, as the extraction's cut reads
    ``cattr[corners]`` (C = 5): their gradient zero, or not (the heaviest
    contention the merge can meet)."""
    gen = torch.Generator(dev).manual_seed(int(live_run))
    n, real, pad = 400_001, 300_000, 1_000_000
    idx = torch.cat([torch.randint(0, n - 1, (real,), generator=gen, device=dev),
                     torch.full((pad,), n - 1, device=dev)])
    idx = idx[torch.randperm(idx.shape[0], generator=gen, device=dev)]
    g = torch.randn((real + pad, 5), generator=gen, device=dev)
    if not live_run:
        g[idx == n - 1] = 0.0
    _hold_scatter(g, idx, n)


@pytest.mark.parametrize("channels", [1, 3])
def test_gather_backward_kernel_matches_aten_on_random_indices(dev, channels):
    gen = torch.Generator(dev).manual_seed(channels)
    n, m = 100_000, 2_000_000
    idx = torch.randint(0, n, (m,), generator=gen, device=dev)
    g = torch.randn((m, channels), generator=gen, device=dev)
    g[torch.rand(m, generator=gen, device=dev) < 0.3] = 0.0
    _hold_scatter(g, idx, n)


def test_gather_backward_kernel_in_bf16_matches_aten(dev):
    """The MC shade's light lookup: bf16 rows of a 512 × 1024 light, 10⁶
    reads, half of them at texel 0 with a zero gradient."""
    gen = torch.Generator(dev).manual_seed(5)
    n, m = 512 * 1024, 1 << 20
    idx = torch.randint(0, n, (m,), generator=gen, device=dev)
    g = torch.randn((m, 4), generator=gen, device=dev).bfloat16()
    half = torch.rand(m, generator=gen, device=dev) < 0.5
    idx[half], g[half] = 0, 0.0
    _hold_scatter(g, idx, n)


def test_gather_backward_kernel_reads_a_strided_index(dev):
    """``v_pos[t_pos_idx[:, k]]``: a column of the face table, read in place."""
    gen = torch.Generator(dev).manual_seed(2)
    t_pos_idx = torch.randint(0, 5000, (40_000, 3), generator=gen, device=dev)
    t_pos_idx[30_000:] = 4999  # padded faces on one vertex
    v = torch.randn((5000, 3), generator=gen, device=dev, requires_grad=True)
    g = torch.randn((40_000, 3), generator=gen, device=dev)
    g[30_000:] = 0.0
    for k in range(3):
        col = t_pos_idx[:, k]
        assert not col.is_contiguous()
        (got,) = torch.autograd.grad(ga.gather_rows(v, col), v, g)
        (want,) = torch.autograd.grad(v[col], v, g)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gather_backward_wrapper_rejects_bad_arguments(dev):
    g = torch.randn((10, 3), device=dev)
    idx = torch.zeros(10, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        ga.scatter_rows(g.double(), idx, 4)
    with pytest.raises(ValueError):
        ga.scatter_rows(g, idx.int(), 4)
    with pytest.raises(ValueError):
        ga.scatter_rows(g, idx[:5], 4)
    with pytest.raises(ValueError):
        ga.scatter_rows(g, idx.cpu(), 4)


def test_flexicubes_backward_on_the_card_matches_the_cpu(dev):
    """The FlexiCubes extractor's backward at voxel 32 (the default 16,384
    cube and 12,288 edge slots, most of them padded onto the sentinel rows)
    on the card against the CPU, whose row gathers add with aten's
    ``index_put_``: the gradients of x, s, ν, β, α and γ of a weighted sum of
    the vertices, the mSDF and L_dev (the rows a valid face reads) each
    within 1e-4 of its largest element.  The 12 row gathers of the extractor
    launch the kernel once each and skip the zero rows."""
    from gshell_tpu_torch.geometry.cube_grid import build_cube_grid
    from gshell_tpu_torch.geometry.gshell_flexicubes import GShellFlexiCubes

    grid = build_cube_grid(32)
    g = torch.Generator().manual_seed(3)
    x = torch.as_tensor(grid.verts) * 1.4 + (torch.rand(grid.verts.shape, generator=g) - 0.5) * 0.01
    s = torch.linalg.norm(x, dim=-1) - 0.45 + 0.03 * torch.sin(7.0 * x[:, 0])
    nu = 0.2 - x[:, 1] + 0.3 * x[:, 2]
    w = torch.randn((grid.n_cubes, 21), generator=g) * 0.5
    grads, weights = {}, None
    for d in ("cpu", dev):
        inputs = [a.detach().to(d).requires_grad_(True) for a in (x, s, nu, w[:, :12], w[:, 12:20], w[:, 20])]
        mesh = GShellFlexiCubes(grid, d)(*inputs[:3], beta=inputs[3], alpha=inputs[4], gamma=inputs[5])
        if weights is None:  # the rows a valid face reads, as on the CPU
            used = torch.zeros(mesh.verts.shape[0], dtype=torch.bool)
            used[: mesh.n_verts_watertight] = True
            used[mesh.faces[mesh.face_valid].reshape(-1)] = True
            weights = {"verts": torch.randn(mesh.verts.shape, generator=g) * used[:, None],
                       "msdf": torch.randn(mesh.msdf.shape, generator=g) * used}
        loss = (mesh.verts * weights["verts"].to(d)).sum() + (mesh.msdf * weights["msdf"].to(d)).sum() + mesh.l_dev
        before, launches = ga.gather_stats(), kernel_launches()["gather_rows"]
        loss.backward()
        if d != "cpu":
            after = ga.gather_stats()
            assert kernel_launches()["gather_rows"] - launches == 12
            seen = after["rows_seen"] - before["rows_seen"]
            scattered = after["rows_scattered"] - before["rows_scattered"]
            assert 0 < scattered < seen
        grads[str(d)] = [a.grad.cpu() for a in inputs]
    for name, gc, gk in zip(("x", "s", "nu", "beta", "alpha", "gamma"), grads["cpu"], grads[str(dev)]):
        scale = float(gc.abs().max())
        err = float((gk - gc).abs().max()) / scale
        print(f"d/d{name}: largest {scale:.3g}, card vs CPU {err:.3g} of it")
        assert scale > 0 and err <= 1e-4, name
    print(f"rows skipped by the kernel: {1 - scattered / seen:.4f} of {seen}")
