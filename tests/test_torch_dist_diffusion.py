"""The data-parallel G-MeshDiffusion trainer of the port on two gloo ranks
(``tests/torch_dist.py``) against one process and against the JAX
trainer on a 2-device mesh, on the CPU.

The U-Net is ``tests/test_diffusion.py``'s ``TINY`` (dropout 0); two steps
of two microbatches of a global batch of 4, each rank holding 2 rows, with
the JAX trainer's global draws replayed (each rank takes its rows of them).

* The losses equal the one-process step's to 1e-6 relative; the
  parameters, the EMA and both Adam moments after the two steps to 1e-6
  relative norm (readings 1.5e-8, 1.3e-8, 4.9e-7, 5.4e-7) over the
  elements whose gradient RMS is at least 100x Adam's ε (``_live``; over
  90 % of them): the ranks' gradients are averaged, the one process sums
  them in another order, and where a gradient is round-off Adam makes a
  step-sized update of it.  Element by element a few parameters differ by
  up to 2e-5 of the step's learning rate: where the two steps' gradients
  cancel in Adam's first moment, its rounding moves the update.
* Both ranks hold the same values bit for bit.
* Against JAX's ``DiffusionTrainer`` on a 2-device mesh fed the same
  draws: ``test_torch_diffusion.py``'s tolerances (losses 1e-5 relative,
  the state's change 1e-5 relative norm, over the same elements; the
  attention key bias, whose gradient is analytically zero, is among those
  left out).
* With dropout 0.1 the two ranks' masks differ (the seed folds in the rank).
* ``TorchDraws.rows``: the rows of a global draw that W ranks take, each
  drawing only its own, are the one process's, bit for bit.
* The checkpoint is written once, by rank 0, and both ranks restore it.
* ``python -m gshell_tpu_torch.main_diffusion --multihost`` trains a step
  on two gloo ranks with ``--coordinator``, writes its snapshot, and a
  second run under ``torchrun`` resumes from it; only rank 0 prints.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.models import ema as jema
from gshell_tpu.models.unet3d import UNet3DConfig as JConfig
from gshell_tpu.parallel.sharding import make_mesh
from gshell_tpu.train.diffusion import DiffusionTrainConfig as JTrainConfig
from gshell_tpu.train.diffusion import DiffusionTrainer as JTrainer
from gshell_tpu.train.diffusion import DiffusionTrainState as JState
from gshell_tpu_torch.convert import unet_params_from_flax
from gshell_tpu_torch.models import losses
from gshell_tpu_torch.models.ema import EMA
from gshell_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from gshell_tpu_torch.train.diffusion import DiffusionTrainConfig, DiffusionTrainer, DiffusionTrainState
from gshell_tpu_torch.utils.rng import ReplayDraws, TorchDraws
from test_diffusion import TINY as J_TINY
from test_torch_diffusion import trainer_source
from test_torch_unet3d import _flax_like, _flax_shapes
from torch_dist import ROOT, free_port, launch, run_ranks
from torch_parity import assert_close, ncdhw

torch.set_num_threads(1)
D, A, B, STEPS = 8, 2, 4, 2
TINY = dict(data_ch=2, base_channels=16, ch_mult=(1, 2), down_block_types=("ResBlock", "AttnResBlock"),
            up_block_types=("AttnResBlock", "ResBlock"), num_res_blocks=1, num_res_blocks_1st_layer=1, dropout=0.0)
TRAIN = dict(data_ch=2, use_occ=True, num_grad_acc_steps=A, lr=1e-3, warmup=2, grad_clip=1.0, weight_decay=1e-2,
             ema_rate=0.9999)


def test_tiny_is_the_jax_tests_tiny():
    assert JConfig(**TINY) == J_TINY


def _draw_dicts(jtr, keys, x_shape, occ_shape):
    """Each step's replayed draws by name (the global batch's shapes)."""
    out = []
    for key in keys:
        src = trainer_source(jtr.sde, key, A, x_shape, occ_shape)
        d = {"dropout_seed": np.zeros((1,), np.int64)}
        for i in range(A):
            for name, shape in (("labels", (B,)), ("noise", x_shape), ("noise_occ", occ_shape)):
                d[f"micro{i}/{name}"] = src(None, f"micro{i}/{name}", shape, None, None)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    fm = (rng.uniform(size=(1, D, D, D, 2)) > 0.3).astype(np.float32)
    om = (rng.uniform(size=(1, 2 * D, 2 * D, 2 * D, 1)) > 0.3).astype(np.float32)
    batch = {"grid": rng.normal(size=(A, B, D, D, D, 2)).astype(np.float32),
             "occgrid": rng.normal(size=(A, B, 2 * D, 2 * D, 2 * D, 1)).astype(np.float32)}
    p_init = _flax_like(_flax_shapes(JConfig(**TINY), D), np.random.default_rng(5))
    jtr = JTrainer(JTrainConfig(grid_size=D, **TRAIN), JConfig(**TINY), jnp.asarray(fm), jnp.asarray(om),
                   mesh=make_mesh(2))
    p0 = jax.tree_util.tree_map(jnp.array, p_init)
    jst = JState(params=p0, opt_state=jtr.tx.init(p0), ema=jema.ema_init(p0), step=jnp.zeros((), jnp.int32))
    sh = jax.sharding.NamedSharding(jtr.mesh, jax.sharding.PartitionSpec(None, "data"))
    jbatch = {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}
    keys = [jax.random.PRNGKey(100 + s) for s in range(STEPS)]
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, -1, 2))) for k, v in batch.items()}
    x_shape, occ_shape = tuple(tbatch["grid"].shape[1:]), tuple(tbatch["occgrid"].shape[1:])
    draws = _draw_dicts(jtr, keys, x_shape, occ_shape)
    jloss = []
    for key in keys:
        jst, m = jtr.train_step(jst, key, jbatch)
        jloss.append(float(m["loss"]))
    return {"weights": unet_params_from_flax(p_init), "fm": ncdhw(fm), "om": ncdhw(om), "batch": tbatch,
            "draws": draws, "jax": {"loss": jloss, "params": unet_params_from_flax(jst.params),
                                    "ema": unet_params_from_flax(jst.ema.params)}}


def _one_process(s):
    tr = DiffusionTrainer(DiffusionTrainConfig(**TRAIN), UNet3DConfig(**TINY), s["fm"], s["om"])
    model = UNet3D(UNet3DConfig(**TINY))
    model.load_state_dict(s["weights"])
    params = list(model.parameters())
    c = tr.cfg
    st = DiffusionTrainState(model, losses.make_optimizer(params, c.lr, c.warmup, c.grad_clip, c.weight_decay),
                             EMA(params))
    out = {"loss": [], "grad_norm": []}
    for d in s["draws"]:
        st, m = tr.train_step(st, ReplayDraws(lambda kind, name, shape, lo, hi, d=d: d[name]), s["batch"])
        out["loss"].append(m["loss"])
        out["grad_norm"].append(m["grad_norm"])
    out.update(params=[p.detach() for p in params], mu=st.opt.mu, nu=st.opt.nu, ema=st.ema.params,
               names=[k for k, _ in model.named_parameters()])
    return out


def _job(s, **kw):
    return {"train": TRAIN, "unet": TINY, "fm": s["fm"], "om": s["om"], "weights": s["weights"],
            "batch": s["batch"], "draws": s["draws"], "steps": STEPS, **kw}


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    return run_ranks("diffusion_steps", 2, _job(setup, checkpoint=str(d / "checkpoints-meta.pt")), d)


def _rel(a, b, live):
    a = torch.cat([t[m].double() for t, m in zip(a, live)])
    b = torch.cat([t[m].double() for t, m in zip(b, live)])
    return float((a - b).norm() / b.norm())


def _live(nu):
    """The elements whose gradient RMS is 100x Adam's ε or more: the others
    carry round-off (at TINY's width a GroupNorm of two channels leaves the
    time embedding's gradient near zero), which Adam's division by
    √ν + ε turns into updates of the step size that no two summation orders
    share (``test_torch_diffusion.py`` trains wider to avoid them)."""
    return [v.sqrt() > 1e-6 for v in nu]


def test_two_ranks_equal_one_process(setup, two_ranks):
    ref = _one_process(setup)
    live = _live(ref["nu"])
    p0 = [setup["weights"][n] for n in ref["names"]]
    assert sum(int(m.sum()) for m in live) > 0.9 * sum(m.numel() for m in live)
    for o in two_ranks:
        for got, want in zip(o["loss"], ref["loss"]):
            assert abs(got - want) <= 1e-6 * abs(want), (o["loss"], ref["loss"])
        for k in ("params", "ema", "mu", "nu"):
            assert _rel(o[k], ref[k], live) <= 1e-6, k


def test_two_ranks_hold_the_same_values(two_ranks):
    a, b = two_ranks
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for k in ("params", "mu", "nu", "ema"):
        assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k


def test_two_ranks_match_jax_on_a_two_device_mesh(setup, two_ranks):
    j = setup["jax"]
    names = [k for k, _ in UNet3D(UNet3DConfig(**TINY)).named_parameters()]
    live = _live(_one_process(setup)["nu"])
    for got, want in zip(two_ranks[0]["loss"], j["loss"]):
        assert abs(got - want) <= 1e-5 * abs(want), (two_ranks[0]["loss"], j["loss"])
    for k in ("params", "ema"):
        base = [setup["weights"][n] for n in names]
        got = [p - b for p, b in zip(two_ranks[0][k], base)]
        want = [j[k][n] - b for n, b in zip(names, base)]
        assert _rel(got, want, live) <= 1e-5, k


def test_checkpoint_written_once_and_restored_by_both_ranks(two_ranks):
    assert len(two_ranks[0]["writes"]) == 1 and two_ranks[1]["writes"] == []
    for o in two_ranks:
        assert o["restored_step"] == STEPS
        assert all(torch.equal(x, y) for x, y in zip(o["restored"], o["params"]))


def test_dropout_masks_differ_between_ranks(setup, tmp_path):
    job = _job(setup, steps=1, record_dropout=True, unet={**TINY, "dropout": 0.1})
    a, b = run_ranks("diffusion_steps", 2, job, tmp_path)
    assert len(a["masks"]) == len(b["masks"]) > 0
    assert any(not torch.equal(x, y) for x, y in zip(a["masks"], b["masks"]))
    share = float(torch.cat([m.reshape(-1).float() for m in a["masks"]]).mean())
    assert 0.05 < share < 0.2  # dropout 0.1 (plus exact zeros of the activations)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind, shape, bounds", [("normal", (8, 2, 3, 3, 3), ()), ("randint", (8,), (0, 1000)),
                                                 ("uniform", (8, 5), (-1.0, 2.0))])
def test_row_draws_do_not_depend_on_the_split(world, kind, shape, bounds):
    draws = lambda: TorchDraws(torch.Generator().manual_seed(3)).child("micro0")
    whole = draws().rows(kind, "x", shape, 0, shape[0], *bounds)
    n = shape[0] // world
    parts = torch.cat([draws().rows(kind, "x", shape, r * n, n, *bounds) for r in range(world)])
    assert whole.shape == shape and torch.equal(parts, whole)
    assert len(torch.unique(whole.reshape(shape[0], -1), dim=0)) == shape[0]  # every row a stream of its own


def _cli(tmp_path, files, extra):
    return ["-m", "gshell_tpu_torch.main_diffusion", "--mode", "train", "--multihost", "--device", "cpu",
            "--data-glob", os.path.join(str(files), "*.npz"), "--workdir", str(tmp_path / "run"),
            "--grid-size", "4", "--data-ch", "2", "--base-channels", "8", "--ch-mult", "1,2", "--batch", "2",
            "--grad-acc", "1", "--snapshot-freq", "1", "--log-freq", "1"] + extra


def test_main_diffusion_multihost_trains_and_resumes(tmp_path):
    files = tmp_path / "grids"
    files.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        np.savez(files / f"g{i}.npz", grid=rng.normal(size=(4, 4, 4, 2)).astype(np.float32),
                 occgrid=rng.normal(size=(8, 8, 8)).astype(np.float32))
    port = free_port()
    first = launch([[sys.executable] + _cli(tmp_path, files, [
        "--n-iters", "2", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r)])
        for r in range(2)], timeout=120)
    assert "step 1: loss=" in first[0][0] and first[1][0] == "", first
    assert "2 ranks over gloo" in first[0][0]
    assert os.path.exists(tmp_path / "run" / "checkpoints-meta.pt")
    (out, err), = launch([[sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                           "--master-port", str(free_port())] + _cli(tmp_path, files, ["--n-iters", "3"])],
                         timeout=120, cwd=ROOT)
    assert "step 2," in out and "step 2: loss=" in out and "step 1: loss" not in out, out
