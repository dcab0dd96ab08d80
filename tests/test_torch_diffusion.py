"""The port's diffusion training (``gshell_tpu_torch/models/{sde,losses,ema}.py``,
``train/diffusion.py``, ``data/grids.py``) against the JAX package.

* The VPSDE tables to 2e-6 relative (√(1 − ᾱ) to 2e-6 absolute; both
  build them in float32, XLA fuses and orders the products its own way),
  ``perturb`` / ``ddim_step`` / ``ancestral_step`` to 1e-6.
* The loss with JAX's draws replayed (``gshell_tpu.models.losses.
  sample_perturbation`` under the same key) to 1e-5 relative.
* Three trainer steps with gradient accumulation 2 and warmup 2, from the
  same weights, with each microbatch's draws replayed from the JAX
  trainer's per-microbatch key split: losses, parameters, both Adam moments
  and the EMA to 1e-5 (relative norm difference per tensor; the first step
  has learning rate 0 on both sides and leaves the parameters as they were).
* The optimizer alone against optax: clipping with and without the
  trigger, decoupled weight decay on every leaf, float32 bias correction.
* The file-index stream of ``GridSampler`` against ``DistributedGridSampler``,
  bit for bit, from step 0 and from a resumed step.
* A checkpoint round trip, and 2 + 2 resumed steps equal to 4 straight,
  bit for bit on the CPU under ``torch.use_deterministic_algorithms(True)``.

Dropout cannot be replayed (flax draws it from its own key), so the parity
runs at dropout 0; dropout is held to its rate and its 1/(1 − p) scale.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.data.multihost import DistributedGridSampler
from gshell_tpu.models import ema as jema
from gshell_tpu.models import losses as jlosses
from gshell_tpu.models import sde as jsde
from gshell_tpu.models.unet3d import UNet3D as JUNet3D
from gshell_tpu.models.unet3d import UNet3DConfig as JConfig
from gshell_tpu.parallel.sharding import make_mesh
from gshell_tpu.train.diffusion import DiffusionTrainConfig as JTrainConfig
from gshell_tpu.train.diffusion import DiffusionTrainer as JTrainer
from gshell_tpu.train.diffusion import DiffusionTrainState as JState
from gshell_tpu_torch import main_diffusion
from gshell_tpu_torch.convert import unet_params_from_flax
from gshell_tpu_torch.data.grids import GridSampler
from gshell_tpu_torch.models import losses, sde
from gshell_tpu_torch.models.ema import EMA
from gshell_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from gshell_tpu_torch.train.diffusion import DiffusionTrainConfig, DiffusionTrainer, DiffusionTrainState
from gshell_tpu_torch.utils.rng import ReplayDraws
from test_torch_unet3d import _flax_like, _flax_shapes
from torch_parity import assert_close, cosine_and_norm, n, ncdhw, ndhwc_shape

torch.set_num_threads(1)
D = 8
SMALL = dict(data_ch=4, base_channels=8, ch_mult=(1, 2), down_block_types=("ResBlock", "AttnResBlock"),
             up_block_types=("AttnResBlock", "ResBlock"), num_res_blocks=1, num_res_blocks_1st_layer=1,
             dropout=0.0)
# The trainer runs at base 48: every GroupNorm group then holds 3 or more
# channels.  With one channel per group (base 8) the bias and time-embedding
# projection feeding a GroupNorm have an analytically zero gradient, and
# Adam turns its round-off into full-size updates that no two
# implementations share.
WIDE = {**SMALL, "base_channels": 48}
TRAIN = dict(data_ch=4, use_occ=True, num_grad_acc_steps=2, lr=1e-3, warmup=2, grad_clip=1.0,
             weight_decay=1e-2, ema_rate=0.9999)


def _rel(a, b) -> float:
    return cosine_and_norm(a, b)[1] if float(np.linalg.norm(n(b))) > 0 else float(np.abs(n(a)).max())


# ---------------------------------------------------------------- the SDE


@pytest.mark.parametrize("table", ["discrete_betas", "alphas", "alphas_cumprod", "sqrt_alphas_cumprod",
                                   "sqrt_1m_alphas_cumprod"])
def test_vpsde_tables_match_jax(table):
    """A few ulp apart: XLA fuses ``linspace``'s products and multiplies the
    ``cumprod`` in its own order.  √(1 − ᾱ) inherits ᾱ's absolute error,
    which is large against its small values at the first timesteps."""
    a, b = getattr(sde.make_vpsde(), table), getattr(jsde.make_vpsde(), table)
    assert a.dtype == torch.float32
    if table == "sqrt_1m_alphas_cumprod":
        assert_close(a, b, rtol=0.0, atol=2e-6, what=table)
    else:
        assert_close(a, b, rtol=2e-6, atol=0.0, what=table)


def test_sde_updates_match_jax():
    rng = np.random.default_rng(0)
    x, eps, noise = (rng.normal(size=(3, 2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    labels = np.array([0, 411, 999])
    ts, tj = sde.make_vpsde(), jsde.make_vpsde()
    assert_close(sde.perturb(ts, torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(noise)),
                 jsde.perturb(tj, x, labels, noise), rtol=1e-6, atol=1e-7, what="perturb")
    for t, tp in ((999, 800), (411, 0), (3, 0)):
        for got, want in zip(sde.ddim_step(ts, torch.from_numpy(x), torch.from_numpy(eps), t, tp),
                             jsde.ddim_step(tj, x, eps, t, tp)):
            assert_close(got, want, rtol=1e-6, atol=1e-6, what=f"ddim {t}")
        key = jax.random.PRNGKey(t)
        want = jsde.ancestral_step(tj, key, x, eps, t)
        got = sde.ancestral_step(ts, torch.from_numpy(np.array(jax.random.normal(key, x.shape))),
                                 torch.from_numpy(x), torch.from_numpy(eps), t)
        for a, b in zip(got, want):
            assert_close(a, b, rtol=1e-6, atol=1e-6, what=f"ancestral {t}")


# ---------------------------------------------------------------- the loss


def perturbation_source(tsde, key, x_shape, occ_shape):
    """Replay source of ``sample_perturbation`` under JAX ``key`` (port shapes)."""
    labels, noise, _, noise_occ, _, _ = jlosses.sample_perturbation(
        tsde, key, jnp.zeros(ndhwc_shape(x_shape)), jnp.zeros(ndhwc_shape(occ_shape)) if occ_shape else None)
    vals = {"labels": np.asarray(labels), "noise": np.moveaxis(np.asarray(noise), -1, 1)}
    if occ_shape:
        vals["noise_occ"] = np.moveaxis(np.asarray(noise_occ), -1, 1)
    return vals


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    params = _flax_like(_flax_shapes(JConfig(**SMALL), D), rng)
    fm = (rng.uniform(size=(1, D, D, D, 4)) > 0.3).astype(np.float32)
    om = (rng.uniform(size=(1, 2 * D, 2 * D, 2 * D, 1)) > 0.3).astype(np.float32)
    batch = {"grid": rng.normal(size=(2, 2, D, D, D, 4)).astype(np.float32),
             "occgrid": rng.normal(size=(2, 2, 2 * D, 2 * D, 2 * D, 1)).astype(np.float32)}
    return dict(params=params, fm=fm, om=om, batch=batch)


def _port_model(params) -> UNet3D:
    m = UNet3D(UNet3DConfig(**SMALL))
    m.load_state_dict(unet_params_from_flax(params))
    return m


@pytest.mark.parametrize("with_occ", [True, False])
def test_loss_with_replayed_draws_matches_jax(setup, with_occ):
    s, key = setup, jax.random.PRNGKey(7)
    tj, ts = jsde.make_vpsde(), sde.make_vpsde()
    jm = JUNet3D(JConfig(**SMALL))
    apply_fn = lambda p, x, o, t, train=False, rngs=None: jm.apply(
        {"params": p}, x, o, t, feature_mask=jnp.asarray(s["fm"]), occ_mask=jnp.asarray(s["om"]))
    batch_j = {"grid": jnp.asarray(s["batch"]["grid"][0])}
    batch_t = {"grid": ncdhw(s["batch"]["grid"][0])}
    if with_occ:
        batch_j["occgrid"] = jnp.asarray(s["batch"]["occgrid"][0])
        batch_t["occgrid"] = ncdhw(s["batch"]["occgrid"][0])
    loss_fn = jlosses.make_ddpm_loss_fn(tj, apply_fn, jnp.asarray(s["fm"]), jnp.asarray(s["om"]))
    want = float(jax.jit(lambda p: loss_fn(p, key, batch_j, train=False))(s["params"]))
    vals = perturbation_source(tj, key, tuple(batch_t["grid"].shape),
                               tuple(batch_t["occgrid"].shape) if with_occ else None)
    draws = ReplayDraws(lambda kind, name, shape, lo, hi: vals[name])
    model = _port_model(s["params"]).eval()
    with torch.no_grad():
        got = float(losses.ddpm_loss(ts, model, draws, batch_t, ncdhw(s["fm"]), ncdhw(s["om"])))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_masked_score_mse_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32), rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32)
    c, d = rng.normal(size=(2, 1, 8, 8, 8)).astype(np.float32), rng.normal(size=(2, 1, 8, 8, 8)).astype(np.float32)
    fm = (rng.uniform(size=(1, 3, 4, 4, 4)) > 0.5).astype(np.float32)
    om = (rng.uniform(size=(1, 1, 8, 8, 8)) > 0.5).astype(np.float32)
    tt = lambda v: torch.from_numpy(v)
    for args in ((a, c, b, d, fm, om), (a, None, b, None, None, None), (a, c, b, d, None, None)):
        want = float(jlosses.masked_score_mse(*(None if v is None else jnp.asarray(v) for v in args), 2))
        got = float(losses.masked_score_mse(*(None if v is None else tt(v) for v in args), 2))
        assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------- the trainer


def trainer_source(tsde, key, a, x_shape, occ_shape):
    """Replay source of one port train step under the JAX step ``key``:
    microbatch ``i`` takes ``sample_perturbation``'s draws under the ``i``-th
    sub-key of the JAX trainer's ``k, sub = split(k)`` chain; the dropout
    seed is unused at dropout 0."""
    per_micro, k = [], key
    for _ in range(a):
        k, sub = jax.random.split(k)
        per_micro.append(perturbation_source(tsde, sub, x_shape, occ_shape))

    def source(kind, name, shape, lo, hi):
        if name == "dropout_seed":
            return np.zeros(shape, np.int64)
        top, _, rest = name.partition("/")
        return per_micro[int(top[len("micro"):])][rest]

    return source


def _jax_mu_nu(state):
    adam = state.opt_state[1][0]
    return adam.mu, adam.nu


@pytest.fixture(scope="module")
def three_steps(setup):
    """The JAX and the port trainer, three steps each from the same weights."""
    s = setup
    jtr = JTrainer(JTrainConfig(grid_size=D, **TRAIN), JConfig(**WIDE), jnp.asarray(s["fm"]), jnp.asarray(s["om"]))
    p_init = _flax_like(_flax_shapes(JConfig(**WIDE), D), np.random.default_rng(5))
    p0 = jax.tree_util.tree_map(jnp.array, p_init)  # train_step donates its state
    jst = JState(params=p0, opt_state=jtr.tx.init(p0), ema=jema.ema_init(p0), step=jnp.zeros((), jnp.int32))
    ttr = DiffusionTrainer(DiffusionTrainConfig(**TRAIN), UNet3DConfig(**WIDE), ncdhw(s["fm"]), ncdhw(s["om"]))
    model = UNet3D(UNet3DConfig(**WIDE))
    model.load_state_dict(unet_params_from_flax(p0))
    params = list(model.parameters())
    c = ttr.cfg
    tst = DiffusionTrainState(model, losses.make_optimizer(params, c.lr, c.warmup, c.grad_clip, c.weight_decay),
                              EMA(params))
    jbatch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 2))) for k, v in s["batch"].items()}
    x_shape, occ_shape = tuple(tbatch["grid"].shape[1:]), tuple(tbatch["occgrid"].shape[1:])
    out = {"loss_j": [], "loss_t": [], "after_first": None}
    for step in range(3):
        key = jax.random.PRNGKey(100 + step)
        jst, mj = jtr.train_step(jst, key, jbatch)
        draws = ReplayDraws(trainer_source(jtr.sde, key, 2, x_shape, occ_shape))
        tst, mt = ttr.train_step(tst, draws, tbatch)
        out["loss_j"].append(float(mj["loss"]))
        out["loss_t"].append(mt["loss"])
        if step == 0:
            out["after_first"] = ([p.detach().clone() for p in params], unet_params_from_flax(jst.params))
    out.update(jst=jst, tst=tst, p0=unet_params_from_flax(p_init))
    return out


def test_three_steps_losses_match_jax(three_steps):
    for got, want in zip(three_steps["loss_t"], three_steps["loss_j"]):
        assert abs(got - want) <= 1e-5 * abs(want), (three_steps["loss_t"], three_steps["loss_j"])


def test_first_step_has_learning_rate_zero(three_steps):
    port, jax_after = three_steps["after_first"]
    names = [k for k, _ in three_steps["tst"].model.named_parameters()]
    for name, p in zip(names, port):
        assert torch.equal(p, three_steps["p0"][name]), name
        assert torch.equal(jax_after[name], three_steps["p0"][name]), name


@pytest.mark.parametrize("what", ["params", "mu", "nu", "ema"])
def test_three_steps_state_matches_jax(three_steps, what):
    """Over all parameters (relative norm difference), the moments also
    element by element against the largest magnitude of all; parameters and
    EMA as their change from the initial weights.  The attention key bias is left out: softmax over the keys
    ignores a shift common to all of them, so its gradient is analytically
    zero and Adam's update of it is round-off scaled up to the step size."""
    jst, tst, p0 = three_steps["jst"], three_steps["tst"], three_steps["p0"]
    mu, nu = _jax_mu_nu(jst)
    want = unet_params_from_flax({"params": jst.params, "mu": mu, "nu": nu, "ema": jst.ema.params}[what])
    got = {"params": [p.detach() for p in tst.model.parameters()], "mu": tst.opt.mu, "nu": tst.opt.nu,
           "ema": tst.ema.params}[what]
    kept = [(k, g) for (k, _), g in zip(tst.model.named_parameters(), got)
            if not k.endswith("AttnBlock_0.Conv_1.bias")]
    assert len(kept) == len(got) - 4
    names, got = [k for k, _ in kept], [g for _, g in kept]
    base = {k: p0[k] if what in ("params", "ema") else torch.zeros_like(p0[k]) for k in names}
    a = torch.cat([(g - base[k]).reshape(-1).double() for k, g in zip(names, got)])
    b = torch.cat([(want[k] - base[k]).reshape(-1).double() for k in names])
    scale = float(b.abs().max())
    assert scale > 0
    assert float((a - b).norm() / b.norm()) <= 1e-5
    if what in ("mu", "nu"):  # an update is m̂ / (√v̂ + ε) of its own element: small gradients set it
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_three_steps_counters_match_jax(three_steps):
    jst, tst = three_steps["jst"], three_steps["tst"]
    assert tst.step == int(jst.step) == 3
    assert tst.opt.count == int(jst.opt_state[1][0].count) == 3
    assert tst.ema.num_updates == int(jst.ema.num_updates) == 3


def test_parameters_moved_after_warmup(three_steps):
    names = [k for k, _ in three_steps["tst"].model.named_parameters()]
    moved = [float((p.detach() - three_steps["p0"][k]).abs().max())
             for k, p in zip(names, three_steps["tst"].model.parameters())]
    assert min(moved) > 0


def test_train_step_rejects_accumulation_axis_mismatch(setup):
    ttr = DiffusionTrainer(DiffusionTrainConfig(**{**TRAIN, "num_grad_acc_steps": 1}), UNet3DConfig(**SMALL))
    model = _port_model(setup["params"])
    st = DiffusionTrainState(model, losses.make_optimizer(list(model.parameters())), EMA(model.parameters()))
    batch = {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 2))) for k, v in setup["batch"].items()}
    with pytest.raises(ValueError, match="accumulation"):
        ttr.train_step(st, ReplayDraws(lambda *a: None), batch)


# ---------------------------------------------------------------- optimizer and EMA


@pytest.mark.parametrize("grad_scale", [10.0, 0.01])  # clipped / under the clip
def test_adamw_matches_optax(grad_scale):
    """Clip by the global norm (scale max_norm / norm, no +1e-6), warmup from
    count 0 (the first update has lr 0), decoupled weight decay on every
    leaf, float32 bias corrections."""
    rng = np.random.default_rng(1)
    names = ["w", "bias", "scale"]
    p0 = {k: rng.normal(size=(5, 3) if k == "w" else (3,)).astype(np.float32) for k in names}
    tx = jlosses.make_optimizer(lr=1e-2, warmup=3, grad_clip=1.0, weight_decay=0.1)
    pj, sj = {k: jnp.asarray(v) for k, v in p0.items()}, None
    sj = tx.init(pj)
    pt = [torch.from_numpy(p0[k].copy()) for k in names]
    opt = losses.make_optimizer(pt, lr=1e-2, warmup=3, grad_clip=1.0, weight_decay=0.1)
    for step in range(5):
        g = {k: (rng.normal(size=v.shape) * grad_scale).astype(np.float32) for k, v in p0.items()}
        upd, sj = tx.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = jax.tree_util.tree_map(lambda a, b: a + b, pj, upd)
        norm = opt.step([torch.from_numpy(g[k]) for k in names])
        assert abs(norm - math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))) < 1e-4 * norm
        for k, p in zip(names, pt):
            assert_close(p, pj[k], rtol=1e-6, atol=1e-7, what=f"{k} step {step}")
        if step == 0:
            assert all(np.array_equal(n(p), p0[k]) for k, p in zip(names, pt))
    mu, nu = sj[1][0].mu, sj[1][0].nu
    for i, k in enumerate(names):
        assert_close(opt.mu[i], mu[k], rtol=1e-6, atol=1e-8, what=f"mu {k}")
        assert_close(opt.nu[i], nu[k], rtol=1e-6, atol=1e-8, what=f"nu {k}")


def test_adamw_learning_rate_schedule():
    opt = losses.make_optimizer([torch.zeros(1)], lr=1e-5, warmup=5000)
    assert opt.learning_rate(0) == 0.0
    assert opt.learning_rate(2500) == float(np.float32(1e-5) * np.float32(0.5))
    assert opt.learning_rate(10 ** 6) == float(np.float32(1e-5))


def test_ema_warmup_matches_jax():
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(7,)).astype(np.float32)
    ej, et = jema.ema_init({"p": jnp.asarray(p0)}), EMA([torch.from_numpy(p0)])
    for _ in range(4):
        new = rng.normal(size=(7,)).astype(np.float32)
        ej = jema.ema_update(ej, {"p": jnp.asarray(new)}, 0.9999)
        et.update([torch.from_numpy(new)], 0.9999)
        assert_close(et.params[0], ej.params["p"], rtol=1e-6, atol=1e-7, what="ema")
    assert et.num_updates == int(ej.num_updates) == 4
    assert et.params[0].dtype == torch.float32


def test_dropout_drops_its_share_and_rescales():
    """Dropout cannot be replayed against flax; hold it to its rate p and
    the 1/(1 − p) scale of the kept values."""
    p = 0.1
    block = UNet3D(UNet3DConfig(**{**SMALL, "dropout": p})).ResBlock_0
    torch.manual_seed(0)
    x = torch.randn(1, 8, 8, 8, 8)
    h = torch.nn.functional.silu(block.GroupNormF32_1(block.Conv_0(torch.nn.functional.silu(
        block.GroupNormF32_0(x))))).detach()
    out = torch.nn.functional.dropout(h, block.dropout, True)
    dropped = float((out == 0).float().mean())
    assert abs(dropped - p) < 0.02, dropped
    kept = out != 0
    assert torch.allclose(out[kept], h[kept] / (1 - p), rtol=1e-6)
    block.train()
    a = block(x, torch.zeros(1, 32))
    b = block(x, torch.zeros(1, 32))
    block.eval()
    assert not torch.equal(a, b) and torch.equal(block(x, torch.zeros(1, 32)), block(x, torch.zeros(1, 32)))


# ---------------------------------------------------------------- data


@pytest.fixture(scope="module")
def grid_files(tmp_path_factory):
    d, rng = tmp_path_factory.mktemp("grids"), np.random.default_rng(0)
    files = []
    for i in range(5):
        f = d / f"g{i}.npz"
        np.savez(f, grid=rng.normal(size=(4, 4, 4, 2)).astype(np.float32),
                 occgrid=rng.normal(size=(8, 8, 8)).astype(np.float32))
        files.append(str(f))
    return files


@pytest.mark.parametrize("start", [0, 3])
def test_grid_sampler_index_stream_matches_jax(grid_files, start):
    acc, b = 2, 8
    js = DistributedGridSampler(grid_files, make_mesh(8), 4, acc, b, seed=7, start_step=start)
    ts = GridSampler(grid_files, acc, b, seed=7, start_step=start)
    for step in range(3):
        np.testing.assert_array_equal(ts.indices(start + step),
                                      np.random.default_rng((7, start + step)).integers(5, size=acc * b))
        want, got = js(), ts()
        assert got["grid"].shape == (acc, b, 2, 4, 4, 4) and got["occgrid"].shape == (acc, b, 1, 8, 8, 8)
        np.testing.assert_array_equal(np.moveaxis(n(got["grid"]), 2, -1), np.asarray(want["grid"]))
        np.testing.assert_array_equal(np.moveaxis(n(got["occgrid"]), 2, -1), np.asarray(want["occgrid"]))


# ---------------------------------------------------------------- checkpoints and resume


def _cpu_trainer(setup):
    tr = DiffusionTrainer(DiffusionTrainConfig(**TRAIN), UNet3DConfig(**{**SMALL, "dropout": 0.1}),
                          ncdhw(setup["fm"]), ncdhw(setup["om"]))
    return tr


def _batch(setup):
    return {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 2))) for k, v in setup["batch"].items()}


def _flat(state):
    sd = {f"p/{k}": v for k, v in state.model.state_dict().items()}
    for i, (m, v, e) in enumerate(zip(state.opt.mu, state.opt.nu, state.ema.params)):
        sd.update({f"mu/{i}": m, f"nu/{i}": v, f"ema/{i}": e})
    return sd, (state.step, state.opt.count, state.ema.num_updates)


def test_checkpoint_files_and_graceful_restore(tmp_path):
    """The rolling ``checkpoints-meta.pt`` on every ``save_periodic``, a
    numbered snapshot every ``every`` steps, and ``restore``'s default when
    no file exists (the JAX package's ``utils/checkpoint.py`` names)."""
    from gshell_tpu_torch.utils import checkpoint

    assert checkpoint.restore(str(tmp_path / "absent.pt"), default="none") == "none"
    w = torch.arange(3.0)
    for step in (4, 5):
        checkpoint.save_periodic(str(tmp_path), {"w": w * step, "step": step}, step, every=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_4.pt", "checkpoints-meta.pt"]
    meta, four = (checkpoint.restore(str(tmp_path / f)) for f in ("checkpoints-meta.pt", "checkpoint_4.pt"))
    assert meta["step"] == 5 and torch.equal(meta["w"], w * 5)
    assert four["step"] == 4 and torch.equal(four["w"], w * 4)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_checkpoint_round_trip(setup, tmp_path, deterministic):
    tr = _cpu_trainer(setup)
    st = tr.init_state(main_diffusion._step_draws(0, 0, "cpu"))
    st, _ = tr.train_step(st, main_diffusion._step_draws(0, 0, "cpu"), _batch(setup))
    path = str(tmp_path / "checkpoints-meta.pt")
    tr.save_checkpoint(path, st)
    other = tr.init_state(main_diffusion._step_draws(1, 0, "cpu"))
    assert tr.restore_checkpoint(str(tmp_path / "absent.pt"), other) is other
    restored = tr.restore_checkpoint(path, other)
    (a, ca), (b, cb) = _flat(st), _flat(restored)
    assert ca == cb == (1, 1, 1)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_resumed_steps_equal_straight_steps_bit_for_bit(setup, tmp_path, deterministic):
    """2 steps, a snapshot, a fresh trainer restored from it and 2 more steps
    equal 4 straight steps, dropout 0.1 included (its seed is a draw)."""
    tr, batch = _cpu_trainer(setup), _batch(setup)
    straight = tr.init_state(main_diffusion._step_draws(0, 0, "cpu"))
    for s in range(4):
        straight, _ = tr.train_step(straight, main_diffusion._step_draws(5, s, "cpu"), batch)
    first = tr.init_state(main_diffusion._step_draws(0, 0, "cpu"))
    for s in range(2):
        first, _ = tr.train_step(first, main_diffusion._step_draws(5, s, "cpu"), batch)
    path = str(tmp_path / "checkpoints-meta.pt")
    tr.save_checkpoint(path, first)
    tr2 = _cpu_trainer(setup)
    resumed = tr2.restore_checkpoint(path, tr2.init_state(main_diffusion._step_draws(9, 0, "cpu")))
    for s in range(resumed.step, 4):
        resumed, _ = tr2.train_step(resumed, main_diffusion._step_draws(5, s, "cpu"), batch)
    (a, ca), (b, cb) = _flat(straight), _flat(resumed)
    assert ca == cb == (4, 4, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
