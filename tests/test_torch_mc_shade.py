"""The MC shade's sample walk as the hand kernel pair ``csrc/mc_shade.cu``
against the eager walk (``_MCAccumulate`` over ``_ShadeWalk.block``), which
stays the plain version: on the card, and the dispatch on the CPU.

The card tests import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_mc_shade.py -m cuda --noconftest -q -s

Both walks take the same draws, rows and pool from one ``env_shade`` call on
the card.  The kernel rounds its arithmetic where the eager walk's aten
kernels round, so sample directions, texel choices and shadow tests agree
but for rare ties; sums run in another order.  The shares that differ are
read by a probe of the kernel's forward, ``tests/csrc/mc_shade_probe.cu``,
which the tests build with the kernels' flags (the kernels themselves
carry no probe).
Forward and every input's cotangent within 1e-4 of their norm (f32); the
bf16 light texel's cotangent within one bf16 unit of each texel's and bit
for bit on a single block, where the eager rounding points (each row's
cotangent rounded to bf16, a block's rows summed in f32 and rounded once)
are all there is.  Roughness from 0.1: below it a single specular sample's
lobe is sharp enough that an ulp moves it by percents.
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from gshell_tpu_torch.ops import shade as sh
from gshell_tpu_torch.render.light import update_pdf
from gshell_tpu_torch.utils import kernels
from gshell_tpu_torch.utils.rng import TorchDraws

PROBE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "mc_shade_probe.cu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on a GPU")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """``gs_mc_shade_probe`` of ``tests/csrc/mc_shade_probe.cu``, built with
    the kernels' nvcc flags against ``csrc/mc_shade.cuh``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on a GPU")
    so = str(tmp_path_factory.mktemp("mc_shade_probe") / "probe.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC_DIR, "-o", so, PROBE_SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(so).gs_mc_shade_probe
    fn.argtypes = [ctypes.POINTER(kernels.McShadeArgs), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _occupancy(res=33, n_pts=4000, seed=9):
    """Surface splat of a sphere of radius 0.45 into a [-0.7, 0.7]³ lattice."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_pts, 3))
    pts = 0.45 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    ijk = np.clip(((pts + 0.7) / 1.4 * (res - 1)).astype(np.int64), 0, res - 1)
    occ = np.zeros((res, res, res), np.float32)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = 1.0
    return torch.from_numpy(occ), (-0.7,) * 3, (1.4,) * 3


def _rows(p, seed, one_normal, dev):
    """Pixel rows facing a camera at z = 2.5; the mask's last quarter 0 (a
    compacted shade's tail) and a tenth of the rest."""
    rng = np.random.default_rng(seed)
    gb_pos = rng.uniform(-0.4, 0.4, size=(p, 3))
    nrm = rng.normal(size=(p, 3))
    if one_normal:
        nrm[:] = nrm[0]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    view = np.tile([[0.0, 0.0, 2.5]], (p, 1))
    nrm = np.where(np.sum(nrm * (view - gb_pos), -1, keepdims=True) < 0, -nrm, nrm)
    kd = rng.uniform(0.1, 0.9, size=(p, 3))
    ks = np.stack([np.zeros(p), rng.uniform(0.1, 1.0, p), rng.uniform(0.0, 1.0, p)], -1)
    mask = rng.uniform(size=(p, 1)) < 0.9
    mask[3 * p // 4:] = False
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return f(mask), f(gb_pos + nrm * 1e-3), f(gb_pos), f(nrm), f(view), f(kd), f(ks)


def _ball_sdf(res=33):
    """0.3 less the distance from the centre, on a [-0.7, 0.7]³ lattice
    (occupied where > 0, as the marcher reads it)."""
    x = torch.linspace(-0.7, 0.7, res)
    gx, gy, gz = torch.meshgrid(x, x, x, indexing="ij")
    return 0.3 - torch.sqrt(gx * gx + gy * gy + gz * gz), (-0.7,) * 3, (1.4,) * 3


def _visibility(kind, dev):
    if kind == "field":
        occ, amin, asz = _occupancy()
        return sh.make_shadow_field(occ.to(dev), amin, asz, ko=8)
    if kind in ("nearest", "trilinear"):
        sdf, amin, asz = _ball_sdf()
        return sh.make_sdf_visibility(sdf.to(dev), amin, asz, mode=kind)
    return None


def _walk(dev, p=2048, n=8, bsdf="pbr", vis="field", light_bf16=True, mc_block=8, one_normal=False, seed=0):
    """(walk, mask, tensors) of one ``env_shade`` call on the card; ``vis``
    "field", "nearest" or "trilinear" (the marcher) or None."""
    mask, ro, gb_pos, nrm, view, kd, ks = _rows(p, seed, one_normal, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    light = update_pdf((torch.rand((32, 64, 3), generator=gen) * 0.5 + 0.25).to(dev))
    vis = _visibility(vis, dev)
    got = {}
    apply = sh._MCShade.apply

    def grab(walk, m, *t):
        got.update(walk=walk, mask=m, tensors=t)
        return apply(walk, m, *t)

    sh._MCShade.apply = grab
    try:
        sh.env_shade(TorchDraws(torch.Generator(dev).manual_seed(seed)), mask, ro, gb_pos, nrm, view, kd, ks, light,
                     n_samples_x=n, bsdf=bsdf, shadow_scale=0.7, visibility=vis, light_pool=256,
                     mc_block=mc_block, light_bf16=light_bf16)
    finally:
        sh._MCShade.apply = apply
    assert got, "env_shade did not take the kernel"
    return got["walk"], got["mask"], got["tensors"]


def _eager_choices(walk, tensors):
    """The eager forward's texel (n², P), lobe (u_z < p_diffuse) and shadow
    tests (n², P, 2) a sample."""
    seen, vis = [], []
    gather = sh.gather_rows

    def record(src, idx):
        seen.append(idx.detach().clone())
        return gather(src, idx)

    sh.gather_rows = record
    try:
        with torch.no_grad():
            a = dict(zip(walk.names, tensors))
            for j in range(walk.n_blocks):
                vis.append(walk.block(a, j, None)[1])
    finally:
        sh.gather_rows = gather
    texel = torch.cat(seen).reshape(walk.n2, -1)
    cosine = torch.ones_like(texel, dtype=torch.bool) if walk.diffuse_only else walk.u[..., 2] < tensors[5][:, 0]
    return texel, cosine, torch.cat(vis)


def _kernel_choices(probe, walk, mask, tensors):
    """The kernel's texel, lobe and shadow tests a sample (the probe); -1 on
    the rows it skips."""
    _, rows = sh.mc_walk_kernel(walk, mask, tensors)
    p = rows.shape[0]
    tex = torch.full((walk.n2, p), -2, dtype=torch.int32, device=rows.device)
    vis = torch.zeros((walk.n2, p, 2), dtype=torch.float32, device=rows.device)
    pool, light = tensors[6].contiguous(), tensors[7].contiguous()
    args = sh._kernel_args(walk, rows, pool, light)
    kernels.check(probe(ctypes.byref(args), tex.data_ptr(), vis.data_ptr(), kernels.stream_ptr(rows)),
                  "mc_shade_probe")
    return tex, vis


def _both(walk, mask, tensors, g):
    """(out, grads) of the eager walk and of the kernel for cotangent g."""
    res = []
    for fn in (lambda *t: sh._MCAccumulate.apply(walk, *t), lambda *t: sh._MCShade.apply(walk, mask, *t)):
        leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
        out = fn(*leaves) * mask
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        res.append((out.detach(), [torch.zeros_like(x) if y is None else y for x, y in zip(leaves, grads)]))
    return res


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double()) / max(float(torch.linalg.vector_norm(want.double())),
                                                                       1e-30))


def _hold(probe, walk, mask, tensors, label):
    """Forward, every cotangent, the choices, the shadow tests and the
    counters; prints the readings."""
    p = mask.shape[0]
    live = mask[:, 0] != 0
    before = sh.shade_stats()
    g = torch.randn((p, 6), generator=torch.Generator(mask.device).manual_seed(7), device=mask.device) * mask
    (out_e, g_e), (out_k, g_k) = _both(walk, mask, tensors, g)
    after = sh.shade_stats()
    assert after["kernel_walks"] == before["kernel_walks"] + 1
    assert after["eager_walks"] == before["eager_walks"] + 1
    assert after["rows_shaded"] - before["rows_shaded"] == int(live.sum())
    assert after["rows_skipped"] - before["rows_skipped"] == p - int(live.sum())
    assert torch.isfinite(out_e).all() and float(out_e.abs().max()) > 0
    assert torch.equal(out_k[~live], torch.zeros_like(out_k[~live]))
    readings = {"forward": _rel(out_k, out_e)}
    for name, a, b in zip(walk.names, g_k, g_e):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(b).all(), name
        readings[name] = _rel(a.float(), b.float())
    tex, vis_k = _kernel_choices(probe, walk, mask, tensors)
    texel_e, cosine_e, vis_e = _eager_choices(walk, tensors)
    texel_k, cosine_k = (tex // 2).long(), (tex % 2).bool()
    assert bool((tex[:, ~live] == -1).all())
    texel_off = float((texel_k != texel_e)[:, live].float().mean())
    lobe_off = float((cosine_k != cosine_e)[:, live].float().mean())
    vis_off = float((vis_k != vis_e)[:, live].float().mean())
    shadowed = float((vis_e[:, live] == 0).float().mean())
    print(f"{label}: texel differs on {texel_off:.2e} of the samples, lobe on {lobe_off:.2e}, shadow test on "
          f"{vis_off:.2e} ({shadowed:.3f} shadowed); relative error "
          + ", ".join(f"{k} {v:.2e}" for k, v in readings.items()))
    assert lobe_off == 0.0
    assert texel_off <= 1e-3
    assert vis_off <= 1e-3
    assert walk.vis is None or 0.0 < shadowed < 1.0
    bf16_light = walk.names[-1] == "light_packed" and tensors[-1].dtype == torch.bfloat16
    for name, v in readings.items():
        assert v <= (2.0 ** -8 if name == "light_packed" and bf16_light else 1e-4), (name, v)
    if bf16_light:
        a, b = g_k[-1].float(), g_e[-1].float()
        assert bool(((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 24])
@pytest.mark.parametrize("bsdf", ["pbr", "diffuse"])
@pytest.mark.parametrize("field", [True, False], ids=["field", "no_visibility"])
def test_mc_shade_kernel_matches_the_eager_walk(dev, probe, n, bsdf, field):
    p = 2048 if n == 8 else 1024
    walk, mask, tensors = _walk(dev, p=p, n=n, bsdf=bsdf, vis="field" if field else None, seed=n)
    _hold(probe, walk, mask, tensors, f"n {n}, {bsdf}, {'field' if field else 'no visibility'}")


@pytest.mark.cuda
@pytest.mark.parametrize("bsdf", ["pbr", "diffuse"])
@pytest.mark.parametrize("mode", ["nearest", "trilinear"])
def test_mc_shade_kernel_marches_the_sdf_as_the_eager_walk(dev, probe, bsdf, mode):
    """The SDF marcher (``shadow_method`` "march") inside the kernel."""
    walk, mask, tensors = _walk(dev, p=2048, n=8, bsdf=bsdf, vis=mode, seed=11)
    assert isinstance(walk.vis, sh.SdfVisibility) and walk.vis.mode == mode
    _hold(probe, walk, mask, tensors, f"marcher {mode}, {bsdf}")


@pytest.mark.cuda
@pytest.mark.parametrize("bsdf", ["pbr", "diffuse"])
def test_mc_shade_kernel_merges_a_hot_texel(dev, probe, bsdf):
    """Every row with one normal: the BSDF samples of a warp crowd a few
    texels, so most of a warp's light cotangents merge before an atomic."""
    walk, mask, tensors = _walk(dev, p=4096, n=8, bsdf=bsdf, one_normal=True, seed=3)
    _hold(probe, walk, mask, tensors, f"one normal, {bsdf}")


@pytest.mark.cuda
def test_mc_shade_kernel_with_an_f32_light(dev, probe):
    walk, mask, tensors = _walk(dev, p=2048, n=8, light_bf16=False, seed=4)
    assert tensors[-1].dtype == torch.float32
    _hold(probe, walk, mask, tensors, "f32 light")


@pytest.mark.cuda
def test_mc_shade_bf16_light_cotangent_is_the_eager_one_bit_for_bit_on_a_block(dev):
    """n² = mc_block: one block, so the light's cotangent is each row's
    rounded to bf16, summed in f32 and rounded once, on both sides."""
    walk, mask, tensors = _walk(dev, p=8192, n=4, mc_block=16, seed=5)
    assert walk.n_blocks == 1
    g = torch.randn((mask.shape[0], 6), generator=torch.Generator(dev).manual_seed(8), device=dev) * mask
    (_, g_e), (_, g_k) = _both(walk, mask, tensors, g)
    a, b = g_k[-1], g_e[-1]
    assert a.dtype == b.dtype == torch.bfloat16
    off = int((a.view(torch.int16) != b.view(torch.int16)).sum())
    print(f"bf16 light cotangent, one block: {off} of {b.numel()} elements differ, "
          f"{int((b != 0).sum())} non-zero")
    assert int((b != 0).sum()) > 100
    assert off == 0


@pytest.mark.cuda
def test_mc_shade_kernel_computes_only_the_cotangents_asked_for(dev):
    walk, mask, tensors = _walk(dev, p=1024, n=8, seed=6)
    g = torch.randn((mask.shape[0], 6), generator=torch.Generator(dev).manual_seed(9), device=dev) * mask
    full = _both(walk, mask, tensors, g)[1][1]
    gn = tensors[0].detach().clone().requires_grad_(True)
    rest = [t.detach() for t in tensors[1:]]
    (got,) = torch.autograd.grad(sh._MCShade.apply(walk, mask, gn, *rest) * mask, gn, g)
    assert torch.equal(got, full[0])


def test_env_shade_on_the_cpu_takes_the_eager_walk():
    p = 64
    gen = torch.Generator().manual_seed(0)
    nrm = torch.nn.functional.normalize(torch.randn((p, 3), generator=gen), dim=-1)
    nrm[:, 2] = nrm[:, 2].abs()
    pos = torch.rand((p, 3), generator=gen) * 0.2
    ks = torch.stack([torch.zeros(p), torch.full((p,), 0.5), torch.rand(p, generator=gen)], -1)
    light = update_pdf(torch.rand((8, 16, 3), generator=gen) + 0.25)
    before = sh.shade_stats()
    out = sh.env_shade(TorchDraws(torch.Generator().manual_seed(1)), torch.ones((p, 1)), pos, pos, nrm,
                       torch.tensor([[0.0, 0.0, 2.0]]).expand(p, 3), torch.full((p, 3), 0.5), ks, light,
                       n_samples_x=2, mc_block=2, light_pool=16)
    after = sh.shade_stats()
    assert after["eager_walks"] == before["eager_walks"] + 1
    assert after["kernel_walks"] == before["kernel_walks"]
    assert (after["rows_shaded"], after["rows_skipped"]) == (before["rows_shaded"], before["rows_skipped"])
    assert torch.isfinite(out.diffuse).all() and float(out.diffuse.abs().max()) > 0


def test_takes_kernel_on_the_card_always_and_raises_on_what_the_kernel_cannot_take():
    cuda, cpu, f32, bf16 = torch.device("cuda", 0), torch.device("cpu"), torch.float32, torch.bfloat16
    occ = torch.zeros((5, 5, 5))
    occ[2, 2, 2] = 1.0
    field = sh.make_shadow_field(occ, (-1.0,) * 3, (2.0,) * 3, ko=2)
    marcher = sh.make_sdf_visibility(occ, (-1.0,) * 3, (2.0,) * 3, n_steps=2)
    rows = [f32] * 8
    assert sh.takes_kernel(cuda, rows, bf16, None)
    assert sh.takes_kernel(cuda, rows, f32, field)
    assert sh.takes_kernel(cuda, rows, bf16, marcher)
    assert not sh.takes_kernel(cpu, rows, bf16, field)
    assert not sh.takes_kernel(cpu, rows, bf16, marcher)
    assert not sh.takes_kernel(cpu, [torch.float64] * 8, torch.float16, None)
    with pytest.raises(TypeError, match="float64"):
        sh.takes_kernel(cuda, [torch.float64] + rows[1:], bf16, None)
    with pytest.raises(TypeError, match="light torch.float16"):
        sh.takes_kernel(cuda, rows, torch.float16, None)
    with pytest.raises(TypeError, match="marcher grid torch.float64"):
        sh.takes_kernel(cuda, rows, bf16, marcher._replace(grid=marcher.grid.double()))
