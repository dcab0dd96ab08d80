"""The port's 3D U-Net (``gshell_tpu_torch/models/unet3d.py``) against the
flax ``UNet3D`` of the JAX package.

Seeded weights in flax's layout (no near-zero output convolutions, so every
layer carries gradient) are carried to the port
(``convert.unet_params_from_flax``), and both packages run the same NCDHW / NDHWC inputs,
masks and timesteps at d = 8, base 8, ``ch_mult (1, 2)`` with attention in
the down and up path.  Both heads agree to 1e-5 relative (of each output's
largest magnitude) and the gradients of a weighted sum of both heads, per
parameter group, to a relative norm difference of 1e-5.  The stride-2
occupancy stem and the transposed-convolution occupancy head are held
alone, the full default configuration's parameter names, shapes and count
through ``jax.eval_shape`` (no memory), and the init against flax's
``variance_scaling(scale, "fan_avg", "uniform")`` limits.
"""
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.models.unet3d import UNet3D as JUNet3D
from gshell_tpu.models.unet3d import UNet3DConfig as JConfig
from gshell_tpu.models.unet3d import ddpm_init
from gshell_tpu_torch.convert import unet_params_from_flax
from gshell_tpu_torch.models.unet3d import (SameConvS2, UNet3D, UNet3DConfig, ZERO_INIT, compute_policy,
                                            init_unet, n_params)
from gshell_tpu_torch.utils.rng import TorchDraws
from torch_parity import assert_close, cosine_and_norm, n, ncdhw

torch.set_num_threads(1)
D = 8
SMALL = dict(data_ch=4, base_channels=8, ch_mult=(1, 2), down_block_types=("ResBlock", "AttnResBlock"),
             up_block_types=("AttnResBlock", "ResBlock"), num_res_blocks=1, num_res_blocks_1st_layer=1,
             dropout=0.0)
GROUPS = ("stem", "down", "mid", "up", "head")


def _flax_like(shapes: dict, rng) -> dict:
    """A flax parameter tree of the given leaf shapes with seeded values:
    kernels ~ N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.05), biases
    N(0, 0.05).  (Flax's own init compiles for ~13 s on the CPU.)"""
    tree = {}
    for path, shape in shapes.items():
        if path[-1] == "kernel":
            v = rng.normal(0.0, 1.0 / math.sqrt(math.prod(shape[:-1])), size=shape)
        else:
            v = (1.0 if path[-1] == "scale" else 0.0) + rng.normal(0.0, 0.05, size=shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(v.astype(np.float32))
    return tree


def _flax_shapes(cfg: JConfig, d: int) -> dict:
    """{path: shape} of flax's parameter tree for ``cfg`` (``jax.eval_shape``,
    no memory, no compile)."""
    tree = jax.eval_shape(lambda: JUNet3D(cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, d, d, d, cfg.data_ch)),
        jnp.zeros((1, 2 * d, 2 * d, 2 * d, 1)), jnp.zeros((1,), jnp.int32))["params"])
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf in flat}


@pytest.fixture(scope="module")
def small():
    """Flax params, the port's model with them, inputs, masks."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, D, D, D, 4)).astype(np.float32)
    occ = rng.normal(size=(2, 2 * D, 2 * D, 2 * D, 1)).astype(np.float32)
    fm = (rng.uniform(size=(1, D, D, D, 4)) > 0.3).astype(np.float32)
    pm = (rng.uniform(size=(1, D, D, D, 1)) > 0.2).astype(np.float32)
    om = (rng.uniform(size=(1, 2 * D, 2 * D, 2 * D, 1)) > 0.3).astype(np.float32)
    ts = np.array([17, 640], np.int32)
    params = _flax_like(_flax_shapes(JConfig(**SMALL), D), rng)
    model = UNet3D(UNet3DConfig(**SMALL))
    model.load_state_dict(unet_params_from_flax(params))
    model.eval()
    return dict(params=params, model=model, x=x, occ=occ, fm=fm, pm=pm, om=om, ts=ts,
                wg=rng.normal(size=x.shape).astype(np.float32), wo=rng.normal(size=occ.shape).astype(np.float32))


@jax.jit
def _jax_apply(params, x, occ, ts, fm, pm, om):
    return JUNet3D(JConfig(**SMALL)).apply({"params": params}, x, occ, ts, feature_mask=fm, pixcat_mask=pm,
                                           occ_mask=om)


def _jax_out(s, params):
    return _jax_apply(params, *(jnp.asarray(s[k]) for k in ("x", "occ", "ts", "fm", "pm", "om")))


def _torch_out(s):
    return s["model"](ncdhw(s["x"]), ncdhw(s["occ"]), torch.from_numpy(s["ts"]).long(), ncdhw(s["fm"]), ncdhw(s["pm"]),
                      ncdhw(s["om"]))


def test_state_dict_names_and_shapes_map_one_to_one(small):
    sd = unet_params_from_flax(small["params"])
    own = small["model"].state_dict()
    assert sorted(sd) == sorted(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)


@pytest.mark.parametrize("head", ["grid", "occ"])
def test_forward_matches_flax(small, head):
    gj, oj = _jax_out(small, small["params"])
    with torch.no_grad(), compute_policy("float32", "cpu"):
        gt, ot = _torch_out(small)
    want = np.moveaxis(np.asarray(gj if head == "grid" else oj), -1, 1)
    got = n(gt if head == "grid" else ot)
    scale = np.abs(want).max()
    assert scale > 1e-3
    assert_close(got, want, rtol=0.0, atol=1e-5 * scale, what=head)
    assert np.array_equal(got == 0, want == 0)  # both masked at the same sites


def test_forward_at_train_false_ignores_the_dropout_mode(small):
    """At dropout 0 the port's train mode gives the eval forward."""
    m = small["model"]
    with torch.no_grad(), compute_policy("float32", "cpu"):
        a = _torch_out(small)
        m.train()
        b = _torch_out(small)
        m.eval()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.fixture(scope="module")
def grads(small):
    s = small

    def loss_j(p):
        g, o = _jax_out(s, p)
        return jnp.sum(g * s["wg"]) + jnp.sum(o * s["wo"])

    gj = jax.jit(jax.grad(loss_j))(s["params"])
    m = s["model"]
    m.zero_grad(set_to_none=True)
    with compute_policy("float32", "cpu"):
        g, o = _torch_out(s)
        (torch.sum(g * ncdhw(s["wg"])) + torch.sum(o * ncdhw(s["wo"]))).backward()
    want = unet_params_from_flax(gj)
    out = {}
    for name, p in m.named_parameters():
        a, b = out.setdefault(m.param_group(name), ([], []))
        a.append(p.grad.reshape(-1))
        b.append(want[name].reshape(-1))
    return {k: (torch.cat(a), torch.cat(b)) for k, (a, b) in out.items()}


@pytest.mark.parametrize("group", GROUPS)
def test_gradients_match_flax_per_group(grads, group):
    got, want = grads[group]
    cos, rel = cosine_and_norm(got, want)
    assert float(want.norm()) > 0
    assert cos > 1 - 1e-9 and rel < 1e-5, (group, cos, rel)
    assert_close(got, want, rtol=0.0, atol=1e-5 * float(want.abs().max()), what=group)


def test_stride2_same_stem_pads_low_0_high_1():
    """Flax's stride-2 3×3×3 ``'SAME'`` conv over 16³ pads (0, 1); a plain
    ``Conv3d(padding=1)`` pads (1, 1) and is off by a voxel."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 16, 3)).astype(np.float32)
    conv = fnn.Conv(5, (3, 3, 3), strides=2)
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = {"kernel": p["kernel"], "bias": jnp.asarray(rng.normal(size=(5,)).astype(np.float32))}
    want = np.moveaxis(np.asarray(conv.apply({"params": p}, jnp.asarray(x))), -1, 1)
    mod = SameConvS2(3, 5)
    sd = unet_params_from_flax({"Conv_2": p})
    mod.load_state_dict({"weight": sd["Conv_2.weight"], "bias": sd["Conv_2.bias"]})
    with torch.no_grad():
        got = n(mod(ncdhw(x)))
        sym = n(torch.nn.functional.conv3d(ncdhw(x), mod.weight, mod.bias, stride=2, padding=1))
    assert got.shape == want.shape == (2, 5, 8, 8, 8)
    assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(sym - want).max() > 1e-2


def test_transposed_occupancy_head_equals_flax_conv_transpose():
    """Flax's ``ConvTranspose`` (k 4, s 2, ``'SAME'``, no kernel transpose)
    is ``conv_transpose3d(stride 2, padding 1)`` with the kernel flipped on
    its spatial axes and laid out (in, out, k, k, k)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 6, 6, 7)).astype(np.float32)
    conv = fnn.ConvTranspose(1, (4, 4, 4), strides=(2, 2, 2), padding="SAME")
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = {"kernel": p["kernel"], "bias": jnp.asarray([0.3], jnp.float32)}
    want = np.moveaxis(np.asarray(conv.apply({"params": p}, jnp.asarray(x))), -1, 1)
    sd = unet_params_from_flax({"ConvTranspose_0": p})
    mod = torch.nn.ConvTranspose3d(7, 1, 4, stride=2, padding=1)
    mod.load_state_dict({"weight": sd["ConvTranspose_0.weight"], "bias": sd["ConvTranspose_0.bias"]})
    with torch.no_grad():
        got = n(mod(ncdhw(x)))
    assert got.shape == want.shape == (2, 1, 12, 12, 12)
    assert_close(got, want, rtol=1e-5, atol=1e-5)


def _torch_shape_of(path, shape):
    """The port's layout of a flax leaf's shape."""
    if path[-1] != "kernel":
        return tuple(shape)
    if len(shape) == 2:
        return (shape[1], shape[0])
    if path[-2].startswith("ConvTranspose"):
        return (shape[3], shape[4]) + tuple(shape[:3])
    return (shape[4], shape[3]) + tuple(shape[:3])


@pytest.fixture(scope="module")
def full_config_shapes():
    """Flax's parameter tree of the default config as shapes only, at the
    JAX trainer's 32³ init proxy (parameters do not depend on the grid)."""
    return _flax_shapes(JConfig(), 32)


def test_full_default_config_names_shapes_and_count(full_config_shapes):
    with torch.device("meta"):
        model = UNet3D(UNet3DConfig())
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {".".join(p[:-1] + ("weight" if p[-1] == "kernel" else p[-1],)): _torch_shape_of(p, s)
            for p, s in full_config_shapes.items()}
    assert sorted(own) == sorted(want)
    assert {k: v for k, v in own.items() if v != want[k]} == {}
    count = sum(math.prod(s) for s in full_config_shapes.values())
    assert n_params(model) == count == 411_065_605


def test_chip_smoke_states_the_jax_parameter_count(full_config_shapes):
    import chip_smoke

    assert chip_smoke.UNET_PARAMS == sum(math.prod(s) for s in full_config_shapes.values())


def _zero_init(name: str) -> bool:
    """The JAX package's ``ddpm_init(0.0)`` sites: each ResBlock's Conv_1,
    each AttnBlock's Conv_3 and the grid head Conv_4."""
    parts = name.split(".")
    return (parts[0].startswith("ResBlock_") and parts[1] == "Conv_1") or \
        parts[-2:] == ["Conv_3", "weight"] and "AttnBlock_0" in parts or name == "Conv_4.weight"


def test_init_follows_flax_variance_scaling_limits():
    """Each kernel of the port's init lies within √(3·scale / fan_avg) with
    flax's receptive-field fans and fills it uniformly, as the JAX package's
    ``ddpm_init(scale)`` does for the same flax-layout shape; biases are 0
    and GroupNorm scales 1."""
    model = init_unet(UNet3D(UNet3DConfig(**SMALL)), TorchDraws(torch.Generator().manual_seed(0)))
    n_zero_init, flax_drawn = 0, {}
    for i, (name, p) in enumerate(model.named_parameters()):
        w = n(p)
        if name.endswith("bias"):
            assert (w == 0).all(), name
            continue
        if name.endswith("scale"):
            assert (w == 1).all(), name
            continue
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        scale = ZERO_INIT if _zero_init(name) else 1.0
        assert mod.init_scale == scale, name
        n_zero_init += scale == ZERO_INIT
        if w.ndim == 2:
            shape = w.shape[::-1]
        elif isinstance(mod, torch.nn.ConvTranspose3d):
            shape = w.shape[2:] + w.shape[:2]
        else:
            shape = w.shape[2:] + (w.shape[1], w.shape[0])
        lim = math.sqrt(3.0 * scale / ((shape[-2] + shape[-1]) * math.prod(shape[:-2]) / 2.0))
        kind = (shape[:-2], isinstance(mod, torch.nn.ConvTranspose3d), scale)
        if kind not in flax_drawn:  # flax's draw, once per kind of kernel (each compiles apart)
            flax_drawn[kind] = np.asarray(ddpm_init(0.0 if scale == ZERO_INIT else 1.0)(
                jax.random.PRNGKey(i), shape))
            w = (w, flax_drawn[kind])
        for a in (w if isinstance(w, tuple) else (w,)):
            assert np.abs(a).max() <= lim * (1 + 1e-6), name
            if a.size >= 2000:
                assert abs(a.std() / (lim / math.sqrt(3.0)) - 1.0) < 0.05, name
    assert len(flax_drawn) >= 6
    blocks = [step for step in model.plan if step[0].startswith("res")]
    assert n_zero_init == len(blocks) + sum(step[4] for step in blocks) + 1


def test_bfloat16_policy_keeps_group_norm_and_outputs_float32(small):
    """Autocast to bf16: convolutions run in bf16, GroupNorm statistics and
    the heads' outputs are float32, and the result stays near float32's."""
    with torch.no_grad():
        with compute_policy("float32", "cpu"):
            g32, o32 = _torch_out(small)
        with compute_policy("bfloat16", "cpu"):
            g16, o16 = _torch_out(small)
    assert g16.dtype == o16.dtype == torch.float32
    for a, b in ((g16, g32), (o16, o32)):
        assert float((a - b).abs().max()) < 0.05 * float(b.abs().max())


def test_remat_gives_the_same_gradients(small):
    m2 = UNet3D(UNet3DConfig(**{**SMALL, "remat": True}))
    m2.load_state_dict(small["model"].state_dict())
    out = []
    for m in (small["model"], m2):
        m.zero_grad(set_to_none=True)
        g, o = m(ncdhw(small["x"]), ncdhw(small["occ"]), torch.from_numpy(small["ts"]).long(), ncdhw(small["fm"]),
                 None, ncdhw(small["om"]))
        (g.square().sum() + o.square().sum()).backward()
        out.append([p.grad.clone() for p in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*out))
