"""The benchmark's copied arithmetic against shapes worked by hand, and
against the originals it was copied from."""
from __future__ import annotations

import math

import pytest

from benchmark import yardstick as ys
from benchmark.inputs.reconstruction import MATERIAL_DIMS
from benchmark.reference.recon.geometry.mlp import MLPConfig, _layer_dims


def test_unet_forward_flops_at_the_configuration_is_50_40_tflop():
    assert round(ys.unet_forward_flops(128) / 1e12, 2) == 50.40


def test_unet_forward_flops_by_hand_at_grid_2():
    """At grid side 2 every level below the first holds one voxel or none
    (2 >> lvl), so the count is small enough to add by hand: the timestep
    MLP, the stems, the blocks at level 0 (8 voxels) and level 1 (1 voxel),
    and the heads."""
    nf, d = 128, 2
    conv = lambda k, a, b, v: 2.0 * k ** 3 * a * b * v
    total = 2.0 * (nf * 4 * nf + 16 * nf * nf) + conv(5, 4, nf, 8) + conv(5, 1, nf, 8) + 2 * conv(3, 1, nf, 8)
    plan, c_last = ys.unet_plan(nf, (1, 2, 2, 4, 4, 4), ys.UNET_DOWN, ys.UNET_UP, 2, 2)
    for kind, cin, cout, attn, skip, lvl in plan:
        v = (d >> lvl) ** 3
        if kind.startswith("res"):
            cin += skip
            total += conv(3, cin, cout, v) + conv(3, cout, cout, v) + 2.0 * 4 * nf * cout
            total += conv(1, cin, cout, v) if cin != cout else 0
            total += 4 * conv(1, cout, cout, v) + 4.0 * v * v * cout if attn else 0
        else:
            total += conv(3, cin, cout, (d >> (lvl + 1 if kind == "down" else lvl - 1)) ** 3)
    total += conv(5, c_last, 4, 8) + conv(4, c_last, 1, 8)
    assert ys.unet_forward_flops(d) == total
    assert len([p for p in plan if p[0] == "res_down"]) == 12 and c_last == nf


def test_unet_forward_flops_equals_the_ports():
    from gshell_tpu_torch.models.unet3d import UNet3DConfig, forward_flops

    for d in (32, 64, 128):
        assert ys.unet_forward_flops(d) == forward_flops(UNet3DConfig(), d)


def test_stencil_taps_and_bound_by_hand():
    assert ys.stencil_taps(3, 3, 1) == 7 * 7  # rows cover 2, 3, 2 taps
    span = 512 * 23 - 2 * sum(range(1, 12))
    assert ys.stencil_taps(512, 512, 11) == span * span
    instr = span * span * (21 + 2 * 7)
    assert ys.stencil_bound_s(512, 512, 11, 6) == pytest.approx(instr / (67e12 / 2))  # operations bound it


def test_stencil_bound_equals_chip_smokes():
    import chip_smoke

    for h, w, c in ((512, 512, 6), (1024, 1024, 3), (48, 80, 6)):
        ms, _ = chip_smoke.stencil_bound(h, w, 11, c)
        assert ys.stencil_bound_s(h, w, 11, c) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_mlp_flops_of_the_sdf_and_material_mlps():
    dims = _layer_dims(MLPConfig(n_freq=6, d_hidden=256, n_hidden=6, skip_in=(3,)))
    emb = 3 * 13
    by_hand = 2 * (emb * 256 + 3 * 256 * 256 + (256 + emb) * 256 + 2 * 256 * 256 + 256 * 1)
    assert ys.mlp_flops(dims) == by_hand
    assert ys.mlp_flops(zip(MATERIAL_DIMS[:-1], MATERIAL_DIMS[1:])) == 2 * (32 * 32 * 2 + 32 * 6)
    assert math.isclose(ys.PEAK_FLOPS["bfloat16"] / ys.PEAK_FLOPS["float32"], 989 / 67)
