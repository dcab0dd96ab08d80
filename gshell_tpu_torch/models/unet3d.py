"""3D U-Net score network with a feature-grid head and an occupancy-grid head
(PyTorch twin of ``gshell_tpu/models/unet3d.py``).

Tensors are NCDHW: the grid (B, C, D, D, D), the occupancy grid
(B, 1, 2D, 2D, 2D) and masks with a batch axis of 1.  Submodules and
parameters carry the names flax gives the JAX package's modules
(``ResBlock_3.Conv_0.weight`` ↔ ``ResBlock_3/Conv_0/kernel``, a GroupNorm's
``scale`` / ``bias`` as they are), so ``convert.unet_params_from_flax`` maps
a flax parameter tree one to one.

* ``GroupNormF32`` normalizes in float32 with ``gcd(32, C)`` groups and eps
  1e-6 through ``F.group_norm`` (one fused kernel that keeps only the
  statistics for the backward).  The JAX package forms the variance as
  E[x²] − E[x]²; the two agree to float32 round-off
  (``tests/test_torch_unet3d.py``).
* Flax's ``'SAME'`` padding is symmetric for the odd stride-1 kernels, but a
  stride-2 3×3×3 convolution over an even extent pads (0, 1): the occupancy
  stems and ``Downsample`` pad explicitly (``SameConvS2``).
* The occupancy head is flax's ``ConvTranspose`` (k 4, s 2, ``'SAME'``,
  ``transpose_kernel=False``), which equals ``conv_transpose3d(stride 2,
  padding 1)`` with the kernel flipped on its spatial axes.
* ``remat`` checkpoints each ResBlock (``torch.utils.checkpoint``; the skip
  is concatenated inside the block, so the saved input is the live
  down-path tensor).  ``compute_dtype`` is applied by :func:`compute_policy`
  around the forward and backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

ZERO_INIT = 1e-10  # ddpm_init(0.0): variance_scaling at 1e-10, not exactly zero


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    data_ch: int = 4
    base_channels: int = 128
    ch_mult: Sequence[int] = (1, 2, 2, 4, 4, 4)
    down_block_types: Sequence[str] = (
        "ResBlock", "ResBlock", "ResBlock", "AttnResBlock", "ResBlock", "ResBlock"
    )
    up_block_types: Sequence[str] = (
        "ResBlock", "ResBlock", "AttnResBlock", "ResBlock", "ResBlock", "ResBlock"
    )
    num_res_blocks: int = 2
    num_res_blocks_1st_layer: int = 2
    dropout: float = 0.1
    resamp_with_conv: bool = True
    use_occ: bool = True
    remat: bool = False
    compute_dtype: str = "float32"


@contextlib.contextmanager
def compute_policy(compute_dtype: str, device_type: str):
    """The precision the forward and backward run in.  ``"float32"`` is IEEE
    float32: TF32 is switched off for cuDNN convolutions and matmuls (torch
    lets cuDNN use TF32 by default).  ``"bfloat16"`` is autocast to bf16,
    with float32 GroupNorm statistics, attention and heads."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device_type, dtype=torch.bfloat16, enabled=compute_dtype == "bfloat16"):
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int, max_positions: int = 10000):
    """DDPM sinusoidal embedding."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    return F.pad(emb, (0, 1)) if embedding_dim % 2 == 1 else emb


def _conv(cin: int, cout: int, k: int, init_scale: float = 1.0) -> nn.Conv3d:
    """Stride-1 ``'SAME'`` convolution (odd ``k``)."""
    c = nn.Conv3d(cin, cout, k, padding=k // 2)
    c.init_scale = init_scale
    return c


class SameConvS2(nn.Conv3d):
    """Flax's stride-2 3×3×3 ``'SAME'`` convolution over an even extent: pad
    (0, 1) on each spatial axis, then a valid convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, stride=2)
        self.init_scale = 1.0

    def forward(self, x):
        return super().forward(F.pad(x, (0, 1, 0, 1, 0, 1)))


def _linear(cin: int, cout: int) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    lin.init_scale = 1.0
    return lin


class GroupNormF32(nn.Module):
    """GroupNorm with float32 statistics, ``gcd(32, C)`` groups, eps 1e-6;
    the output keeps the input's dtype."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups = math.gcd(num_groups, channels)
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            y = F.group_norm(x.float(), self.groups, self.scale, self.bias, self.eps)
        return y.to(x.dtype)


class AttnBlock(nn.Module):
    """Global self-attention over the voxels, products and softmax in float32."""

    def __init__(self, c: int):
        super().__init__()
        self.GroupNormF32_0 = GroupNormF32(c)
        self.Conv_0, self.Conv_1, self.Conv_2 = _conv(c, c, 1), _conv(c, c, 1), _conv(c, c, 1)
        self.Conv_3 = _conv(c, c, 1, ZERO_INIT)

    def forward(self, x):
        b, c = x.shape[:2]
        y = self.GroupNormF32_0(x)
        q, k, v = (m(y).reshape(b, c, -1).float() for m in (self.Conv_0, self.Conv_1, self.Conv_2))
        with torch.autocast(x.device.type, enabled=False):
            attn = torch.softmax(torch.matmul(q.transpose(1, 2), k) * (c ** -0.5), dim=-1)
            out = torch.matmul(v, attn.transpose(1, 2))  # (b, c, tokens)
        return x + self.Conv_3(out.reshape(x.shape).to(x.dtype))


class ResBlock(nn.Module):
    """DDPM ResNet block; ``skip`` (the U-Net's lateral tensor) is
    concatenated inside the block."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, dropout: float, use_attn: bool):
        super().__init__()
        self.dropout = dropout
        self.GroupNormF32_0 = GroupNormF32(in_ch)
        self.Conv_0 = _conv(in_ch, out_ch, 3)
        self.Dense_0 = _linear(temb_ch, out_ch)
        self.GroupNormF32_1 = GroupNormF32(out_ch)
        self.Conv_1 = _conv(out_ch, out_ch, 3, ZERO_INIT)
        if in_ch != out_ch:
            self.Conv_2 = _conv(in_ch, out_ch, 1)
        if use_attn:
            self.AttnBlock_0 = AttnBlock(out_ch)

    def forward(self, x, temb, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        h = self.Conv_0(F.silu(self.GroupNormF32_0(x)))
        h = h + self.Dense_0(F.silu(temb))[:, :, None, None, None]
        h = F.dropout(F.silu(self.GroupNormF32_1(h)), self.dropout, self.training)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        h = x + h
        return self.AttnBlock_0(h) if hasattr(self, "AttnBlock_0") else h


class Downsample(nn.Module):
    def __init__(self, c: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.Conv_0 = SameConvS2(c, c)

    def forward(self, x):
        return self.Conv_0(x) if hasattr(self, "Conv_0") else F.avg_pool3d(x, 2)


class Upsample(nn.Module):
    def __init__(self, c: int, with_conv: bool):
        super().__init__()
        if with_conv:
            self.Conv_0 = _conv(c, c, 3)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.Conv_0(x) if hasattr(self, "Conv_0") else x


def _plan(cfg: UNet3DConfig):
    """The network's blocks in call order, as (kind, index, in_ch, out_ch,
    attn, skip_ch, level): kind "res_down" / "res_mid" / "res_up" for
    ``ResBlock_<index>``, "down" / "up" for ``Downsample_<index>`` /
    ``Upsample_<index>``; ``level`` counts the halvings of the grid side the
    block runs at.  Returns (plan, channels of the last block)."""
    nf, n_levels = cfg.base_channels, len(cfg.down_block_types)
    out, ch, k, c = [], [nf], 0, nf
    for i, btype in enumerate(cfg.down_block_types):
        for _ in range(cfg.num_res_blocks_1st_layer if i == 0 else cfg.num_res_blocks):
            o = nf * cfg.ch_mult[i]
            out.append(("res_down", k, c, o, btype == "AttnResBlock", 0, i))
            c, k = o, k + 1
            ch.append(c)
        if i != n_levels - 1:
            out.append(("down", i, c, c, False, 0, i))
            ch.append(c)
    for attn in (True, False):
        out.append(("res_mid", k, c, c, attn, 0, n_levels - 1))
        k += 1
    for i, btype in enumerate(cfg.up_block_types):
        nrb = cfg.num_res_blocks_1st_layer if i == n_levels - 1 else cfg.num_res_blocks
        for _ in range(nrb + 1):
            o, s = nf * cfg.ch_mult[n_levels - i - 1], ch.pop()
            out.append(("res_up", k, c, o, btype == "AttnResBlock", s, n_levels - 1 - i))
            c, k = o, k + 1
        if i != n_levels - 1:
            out.append(("up", i, c, c, False, 0, n_levels - 1 - i))
    return out, c


class UNet3D(nn.Module):
    """(grid, occ, timesteps, masks) → (grid score, occupancy score), both
    float32 and masked."""

    def __init__(self, cfg: UNet3DConfig):
        super().__init__()
        self.cfg = cfg
        nf = cfg.base_channels
        self.Dense_0 = _linear(nf, 4 * nf)
        self.Dense_1 = _linear(4 * nf, 4 * nf)
        self.Conv_0 = _conv(cfg.data_ch, nf, 5)
        self.Conv_1 = _conv(1, nf, 5)
        if cfg.use_occ:
            self.Conv_2, self.Conv_3 = SameConvS2(1, nf), SameConvS2(1, nf)
        self.plan, c = _plan(cfg)
        for step in self.plan:
            if step[0].startswith("res"):
                _, k, cin, cout, attn, skip, _ = step
                self.add_module(f"ResBlock_{k}", ResBlock(cin + skip, cout, 4 * nf, cfg.dropout, attn))
            elif step[0] == "down":
                self.add_module(f"Downsample_{step[1]}", Downsample(step[2], cfg.resamp_with_conv))
            else:
                self.add_module(f"Upsample_{step[1]}", Upsample(step[2], cfg.resamp_with_conv))
        self.GroupNormF32_0 = GroupNormF32(c)
        self.Conv_4 = _conv(c, cfg.data_ch, 5, ZERO_INIT)
        if cfg.use_occ:
            self.ConvTranspose_0 = nn.ConvTranspose3d(c, 1, 4, stride=2, padding=1)
            self.ConvTranspose_0.init_scale = 1.0

    def param_group(self, name: str) -> str:
        """The part of the network a parameter belongs to: "stem" (the
        timestep MLP and the input convolutions), "down", "mid", "up" (their
        ResBlocks and resamplers) or "head"."""
        top = name.split(".")[0]
        if top in ("Dense_0", "Dense_1", "Conv_0", "Conv_1", "Conv_2", "Conv_3"):
            return "stem"
        if top in ("GroupNormF32_0", "Conv_4", "ConvTranspose_0"):
            return "head"
        if top.startswith(("Downsample_", "Upsample_")):
            return "down" if top.startswith("Down") else "up"
        k = int(top.split("_")[1])
        return next(kind for kind, i, *_ in self.plan if kind.startswith("res") and i == k)[len("res_"):]

    def _res(self, k: int, h, temb, skip=None):
        block = getattr(self, f"ResBlock_{k}")
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(block, h, temb, skip, use_reentrant=False)
        return block(h, temb, skip)

    def forward(self, x, occ, timesteps, feature_mask=None, pixcat_mask=None, occ_mask=None):
        cfg, nf = self.cfg, self.cfg.base_channels
        ones = lambda like, c: torch.ones((1, c) + tuple(like.shape[2:]), dtype=like.dtype, device=like.device)
        feature_mask = ones(x, x.shape[1]) if feature_mask is None else feature_mask
        pixcat_mask = ones(x, 1) if pixcat_mask is None else pixcat_mask
        x = x * feature_mask
        temb = self.Dense_0(get_timestep_embedding(timesteps, nf))
        temb = self.Dense_1(F.silu(temb))
        h = self.Conv_0(x) + self.Conv_1(pixcat_mask)
        with_occ = cfg.use_occ and occ is not None
        if with_occ:
            occ_mask = ones(occ, 1) if occ_mask is None else occ_mask
            h = h + self.Conv_2(occ * occ_mask)
            h = h + self.Conv_3(occ_mask)

        hs, prev = [h], None
        for kind, i, *_ in self.plan:
            if kind == "res_down":
                hs.append(self._res(i, hs[-1], temb))
            elif kind == "down":
                hs.append(getattr(self, f"Downsample_{i}")(hs[-1]))
            elif kind == "res_mid":
                h = self._res(i, h if prev == "res_mid" else hs[-1], temb)
            elif kind == "res_up":
                h = self._res(i, h, temb, hs.pop())
            else:
                h = getattr(self, f"Upsample_{i}")(h)
            prev = kind
        assert not hs
        h = F.silu(self.GroupNormF32_0(h))
        grid = self.Conv_4(h).float() * feature_mask
        grid_occ = self.ConvTranspose_0(h).float() * occ_mask if with_occ else None
        return grid, grid_occ


def n_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def init_unet(model: UNet3D, draws) -> UNet3D:
    """The JAX package's init: every kernel from ``variance_scaling(scale,
    "fan_avg", "uniform")`` (limit √(3·scale / fan_avg), fans counted with
    the receptive field as flax counts them), biases 0, GroupNorm scale 1.
    Kernels are drawn in the port's layout, named by parameter."""
    for name, mod in model.named_modules():
        if not hasattr(mod, "init_scale"):
            continue
        w = mod.weight
        rf = w[0, 0].numel()
        if isinstance(mod, nn.ConvTranspose3d):  # (in, out, k, k, k)
            fan_in, fan_out = w.shape[0] * rf, w.shape[1] * rf
        else:  # Conv3d (out, in, k, k, k), Linear (out, in)
            fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
        lim = math.sqrt(3.0 * mod.init_scale / ((fan_in + fan_out) / 2.0))
        w.copy_(draws.uniform(f"{name}.weight", tuple(w.shape), -lim, lim).to(w))
        mod.bias.zero_()
    return model


def forward_flops(cfg: UNet3DConfig, d: int, with_occ: bool = True) -> float:
    """Analytic operations of one sample's forward at grid side ``d``:
    2·k³·C_in·C_out per output voxel for each convolution (per input voxel
    for the transposed occupancy head), 4·N²·C for each attention's two
    products over N voxels, and 2·in·out for each dense layer."""
    nf = cfg.base_channels
    vox = lambda lvl: (d >> lvl) ** 3
    conv = lambda k, cin, cout, v: 2.0 * k ** 3 * cin * cout * v
    total = 2.0 * (nf * 4 * nf + 16 * nf * nf)  # Dense_0, Dense_1
    total += conv(5, cfg.data_ch, nf, vox(0)) + conv(5, 1, nf, vox(0))
    if with_occ:
        total += 2 * conv(3, 1, nf, vox(0))
    plan, c_last = _plan(cfg)
    for kind, _, cin, cout, attn, skip, lvl in plan:
        if kind.startswith("res"):
            cin += skip
            v = vox(lvl)
            total += conv(3, cin, cout, v) + conv(3, cout, cout, v) + 2.0 * 4 * nf * cout
            if cin != cout:
                total += conv(1, cin, cout, v)
            if attn:
                total += 4 * conv(1, cout, cout, v) + 4.0 * v * v * cout
        elif cfg.resamp_with_conv:  # output at the next level down / up
            total += conv(3, cin, cout, vox(lvl + 1 if kind == "down" else lvl - 1))
    total += conv(5, c_last, cfg.data_ch, vox(0))
    if with_occ:
        total += conv(4, c_last, 1, vox(0))
    return total
