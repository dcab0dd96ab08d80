"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has a GPU and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Without a CUDA device every test skips.  Tolerances: stage B is compared
bit for bit (ids everywhere, z where hit): the kernel rounds its edge and
depth arithmetic like PyTorch's eager ops (no FMA contraction).  The
bilateral stencil to rtol 1e-5 / atol 1e-6: the same taps in the same order,
but the kernel's expf and the fused sums may round an ulp apart.
"""
import math

import pytest
import torch

from gshell_tpu_torch.ops import denoiser as dn
from gshell_tpu_torch.ops import rasterize as rz
from gshell_tpu_torch.ops.math import lookat, perspective, xfm_points

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
    before = rz.stage_b_launches
    kz, kid = rz.rasterize_stage_b(*args)
    torch.cuda.synchronize()
    assert rz.stage_b_launches == before + 1
    pz, pid = rz.stage_b_plain(*args)
    hit = pid >= 0
    assert int(hit.sum()) > 0
    assert torch.equal(kid, pid)
    assert torch.equal(kz[hit], pz[hit])


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


@pytest.mark.parametrize("h, w, r", [(37, 53, 5), (512, 512, 11)])
@pytest.mark.parametrize("from_tap", [False, True])
def test_bilateral_kernel_matches_plain(dev, h, w, r, from_tap):
    col, nrm, zdz = _stencil_inputs(h, w, 3, dev)
    before = dn.bilateral_launches
    kc, kw = dn.bilateral_accumulate(col, nrm, zdz, 2.0, r, denom_from_tap=from_tap)
    torch.cuda.synchronize()
    assert dn.bilateral_launches == before + 1
    pc, pw = dn.bilateral_plain(col, nrm, zdz, 2.0, r, denom_from_tap=from_tap)
    torch.testing.assert_close(kc, pc, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kw, pw, rtol=1e-5, atol=1e-6)


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
    one stage-B launch and four denoiser launches per view."""
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
    sb, bl = rz.stage_b_launches, dn.bilateral_launches
    m = rec.train_step(state, draws.child("step"), target)
    torch.cuda.synchronize()
    assert rz.stage_b_launches - sb == batch
    assert dn.bilateral_launches - bl == 4 * batch
    assert int(m["n_faces"]) > 0 and int(m["raster_dropped"]) == 0
    for k in ("total", "img_loss", "reg_loss"):
        assert math.isfinite(float(m[k])), k
