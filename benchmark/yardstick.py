"""The benchmark's fixed arithmetic: the card's peaks, the operations of the
models' evaluations, and the least time of the bilateral stencil.

Frozen copies, so that a change to the program cannot move the yardstick:
``forward_flops`` of ``models/unet3d.py`` and ``stencil_bound`` of
``chip_smoke.py`` (with the constants they use), at the commit the
benchmark was written against."""
from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
# data sheet): bf16 on the tensor cores, float32 outside them.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FP32_INSTR_PER_S = 67e12 / 2  # an FMA counts as 2 operations
MUFU_PER_S = 132 * 16 * 1.98e9  # special-function units: 16 a clock per SM
HBM_BYTES_PER_S = 3.35e12


# ---- the bilateral stencil (csrc/bilateral.cu) ----
STENCIL_MUFU_PER_TAP = 2  # ex2 and rcp


def stencil_instr_per_tap(channels: int) -> int:
    """Least FP32 instructions per in-image tap, without fast math or FMA
    contraction: normal dot 5, clamp 2, ^128 7, |dz|, dz·dist and max 3,
    division 1, exp 1, weight product 2, and a product and a sum per
    accumulator (C colours + the weight)."""
    return 21 + 2 * (channels + 1)


def stencil_taps(h: int, w: int, r: int) -> int:
    """In-image taps of the (2r+1)² stencil over an h×w image."""
    span = lambda n: sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))
    return span(h) * span(w)


def stencil_bound_s(h: int, w: int, r: int, channels: int) -> float:
    """Least seconds of one stencil launch: the larger of its operations over
    their peak rates and its bytes (each input read once, each output
    written once) over the memory rate."""
    taps = stencil_taps(h, w, r)
    bytes_moved = 4 * h * w * ((channels + 3 + 2) + (channels + 1))  # in: col nrm zdz; out: acc
    t_ops = max(taps * stencil_instr_per_tap(channels) / FP32_INSTR_PER_S, taps * STENCIL_MUFU_PER_TAP / MUFU_PER_S)
    return max(t_ops, bytes_moved / HBM_BYTES_PER_S)


# ---- MLPs ----
def mlp_flops(dims) -> float:
    """Operations of one row through dense layers [(d_in, d_out), ...]."""
    return float(sum(2 * a * b for a, b in dims))


# ---- the G-MeshDiffusion U-Net (models/unet3d.py) ----
def unet_plan(base: int, ch_mult, down_types, up_types, num_res_blocks: int, num_res_blocks_1st: int):
    """The U-Net's blocks in call order, as (kind, in_ch, out_ch, attn,
    skip_ch, level); and the channels of the last block."""
    nf, n_levels = base, len(down_types)
    out, ch, c = [], [nf], nf
    for i, btype in enumerate(down_types):
        for _ in range(num_res_blocks_1st if i == 0 else num_res_blocks):
            o = nf * ch_mult[i]
            out.append(("res_down", c, o, btype == "AttnResBlock", 0, i))
            c = o
            ch.append(c)
        if i != n_levels - 1:
            out.append(("down", c, c, False, 0, i))
            ch.append(c)
    for attn in (True, False):
        out.append(("res_mid", c, c, attn, 0, n_levels - 1))
    for i, btype in enumerate(up_types):
        nrb = num_res_blocks_1st if i == n_levels - 1 else num_res_blocks
        for _ in range(nrb + 1):
            o, s = nf * ch_mult[n_levels - i - 1], ch.pop()
            out.append(("res_up", c, o, btype == "AttnResBlock", s, n_levels - 1 - i))
            c = o
        if i != n_levels - 1:
            out.append(("up", c, c, False, 0, n_levels - 1 - i))
    return out, c


UNET_DOWN = ("ResBlock", "ResBlock", "ResBlock", "AttnResBlock", "ResBlock", "ResBlock")
UNET_UP = ("ResBlock", "ResBlock", "AttnResBlock", "ResBlock", "ResBlock", "ResBlock")


def unet_forward_flops(d: int, data_ch: int = 4, base: int = 128, ch_mult=(1, 2, 2, 4, 4, 4),
                       num_res_blocks: int = 2, num_res_blocks_1st: int = 2, with_occ: bool = True,
                       resamp_with_conv: bool = True) -> float:
    """Operations of one sample's forward at grid side ``d``: 2·k³·C_in·C_out
    per output voxel for each convolution (per input voxel for the
    transposed occupancy head), 4·N²·C for each attention's two products
    over N voxels, and 2·in·out for each dense layer."""
    nf = base
    vox = lambda lvl: (d >> lvl) ** 3
    conv = lambda k, cin, cout, v: 2.0 * k ** 3 * cin * cout * v
    total = 2.0 * (nf * 4 * nf + 16 * nf * nf)  # the timestep MLP
    total += conv(5, data_ch, nf, vox(0)) + conv(5, 1, nf, vox(0))
    if with_occ:
        total += 2 * conv(3, 1, nf, vox(0))
    plan, c_last = unet_plan(base, ch_mult, UNET_DOWN, UNET_UP, num_res_blocks, num_res_blocks_1st)
    for kind, cin, cout, attn, skip, lvl in plan:
        if kind.startswith("res"):
            cin += skip
            v = vox(lvl)
            total += conv(3, cin, cout, v) + conv(3, cout, cout, v) + 2.0 * 4 * nf * cout
            if cin != cout:
                total += conv(1, cin, cout, v)
            if attn:
                total += 4 * conv(1, cout, cout, v) + 4.0 * v * v * cout
        elif resamp_with_conv:
            total += conv(3, cin, cout, vox(lvl + 1 if kind == "down" else lvl - 1))
    total += conv(5, c_last, data_ch, vox(0))
    if with_occ:
        total += conv(4, c_last, 1, vox(0))
    return total
