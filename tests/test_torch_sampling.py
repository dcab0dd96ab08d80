"""The port's samplers and generation modes (``gshell_tpu_torch/models/
{sampling,evaler,likelihood,registry}.py``) against the JAX package.

Both packages draw from the same numbers: a replay source re-derives every
``jax.random`` draw of the JAX sampler from its key chain (the initial
noises, each step's ``fold_in`` keys, each pair's and sample's splits) by
the port's draw name, in the port's NCDHW layout.  The network is an
analytic ε (``tanh`` of the grid, ``sin`` of the occupancy, scaled by the
timestep) written in both frameworks, so the samplers' own arithmetic is
what is compared: to 1e-5 of each output's largest magnitude (over 100
ancestral steps too), 1e-6 relative for one step of each predictor and
corrector.  One DDIM run goes through the small U-Net of both packages.  The likelihood holds the Gaussian case of
``tests/test_diffusion_extras.py`` with the replayed Rademacher probe.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.models import evaler as jevaler
from gshell_tpu.models import likelihood as jlikelihood
from gshell_tpu.models import registry as jregistry
from gshell_tpu.models import sampling as jsampling
from gshell_tpu.models import sde as jsde
from gshell_tpu.models.unet3d import UNet3D as JUNet3D
from gshell_tpu.models.unet3d import UNet3DConfig as JConfig
from gshell_tpu_torch.convert import unet_params_from_flax
from gshell_tpu_torch.models import evaler, likelihood, registry, sampling, sde
from gshell_tpu_torch.models.unet3d import UNet3D, UNet3DConfig, compute_policy
from gshell_tpu_torch.utils.rng import ReplayDraws
from test_torch_unet3d import SMALL, _flax_like, _flax_shapes
from torch_parity import assert_close, n, ncdhw, ndhwc_shape

torch.set_num_threads(1)
D = 4
SHAPE_T, OCC_T = (1, 2, D, D, D), (1, 1, 2 * D, 2 * D, 2 * D)
SHAPE_J, OCC_J = (1, D, D, D, 2), (1, 2 * D, 2 * D, 2 * D, 1)


def _to_t(a):  # NDHWC → NCDHW
    return np.moveaxis(np.asarray(a), -1, 1)


def eps_j(x, x_occ, labels):
    c = (labels.astype(jnp.float32) / 1000.0).reshape(-1, 1, 1, 1, 1)
    return jnp.tanh(x) * (0.5 + c), (0.5 * jnp.sin(x_occ) * c if x_occ is not None else None)


def eps_t(x, x_occ, labels):
    c = (labels.float() / 1000.0).reshape(-1, 1, 1, 1, 1)
    return torch.tanh(x) * (0.5 + c), (0.5 * torch.sin(x_occ) * c if x_occ is not None else None)


def close(got, want, what, tol=1e-5):
    """Within ``tol`` of the largest magnitude of ``want``: the sampled
    values pass through 0, where an element's own relative error means
    nothing."""
    want = np.asarray(want)
    assert_close(got, want, rtol=0.0, atol=tol * float(np.abs(want).max()), what=what)


def _normal(key, port_shape):
    return _to_t(jax.random.normal(key, ndhwc_shape(port_shape)))


def keyed_source(key_of):
    """Replay source: ``key_of(name)`` gives the JAX key of a draw, drawn as
    ``jax.random.normal`` in JAX's layout and moved to the port's."""
    return lambda kind, name, shape, lo, hi: _normal(key_of(name), shape)


def ddim_keys(key):
    k_x, k_occ = jax.random.split(key)
    return {"x": k_x, "x_occ": k_occ}


def pc_key_of(key, n_split=2):
    """Keys of ``get_pc_sampler`` (``n_split`` 2) and ``cond_gen`` (4)."""
    k_x, k_occ, k_loop = jax.random.split(key, 3)
    names = ("x", "x_occ") if n_split == 2 else ("x", "cond", "x_occ", "occ_cond")

    def key_of(name):
        if name in ("x", "x_occ"):
            return k_x if name == "x" else k_occ
        step, _, what = name.partition("/")
        ks = jax.random.split(jax.random.fold_in(k_loop, int(step[len("step"):])), n_split)
        return ks[names.index(what)]

    return key_of


@pytest.mark.parametrize("masked", [False, True])
def test_ddim_sampler_matches_jax(masked):
    rng = np.random.default_rng(0)
    fm = (rng.uniform(size=SHAPE_J) > 0.3).astype(np.float32) if masked else None
    om = (rng.uniform(size=OCC_J) > 0.3).astype(np.float32) if masked else None
    tj, ts = jsde.make_vpsde(), sde.make_vpsde()
    key = jax.random.PRNGKey(3)
    xj, oj = jax.jit(jsampling.get_ddim_sampler(tj, eps_j, SHAPE_J, OCC_J, n_steps=20, feature_mask=fm,
                                                occ_mask=om))(key)
    keys = ddim_keys(key)
    xt, ot = sampling.get_ddim_sampler(ts, eps_t, SHAPE_T, OCC_T, n_steps=20,
                                       feature_mask=None if fm is None else torch.from_numpy(_to_t(fm)),
                                       occ_mask=None if om is None else torch.from_numpy(_to_t(om)))(
        ReplayDraws(keyed_source(keys.__getitem__)))
    close(xt, _to_t(xj), "x")
    close(ot, _to_t(oj), "occ")
    if masked:
        assert (n(xt)[_to_t(fm) == 0] == 0).all() and (n(ot)[_to_t(om) == 0] == 0).all()


@pytest.mark.parametrize("schedule,steps", [("quad", 100), ("quad", 10), ("uniform", 37), ("quad", 1000)])
def test_ddim_timesteps_equal_jax(schedule, steps):
    got = sampling.ddim_timesteps(1000, steps, schedule)
    want = np.asarray(jsampling.ddim_timesteps(1000, steps, schedule))
    np.testing.assert_array_equal(got, want)


def test_pc_sampler_matches_jax():
    """100 ancestral steps with each step's replayed noise; the last step
    returns the mean on both sides."""
    tj, ts = jsde.make_vpsde(n=100), sde.make_vpsde(n=100)
    key = jax.random.PRNGKey(5)
    xj, oj = jax.jit(jsampling.get_pc_sampler(tj, eps_j, SHAPE_J, OCC_J))(key)
    xt, ot = sampling.get_pc_sampler(ts, eps_t, SHAPE_T, OCC_T)(ReplayDraws(keyed_source(pc_key_of(key))))
    assert np.isfinite(n(xt)).all()
    close(xt, _to_t(xj), "x")
    close(ot, _to_t(oj), "occ")


def test_uncond_gen_matches_jax():
    """Sample ``i`` under the ``i``-th key of ``key, k = split(key)``."""
    tj, ts = jsde.make_vpsde(), sde.make_vpsde()
    key = jax.random.PRNGKey(9)
    want, got = [], []
    jax_sampler = jax.jit(jsampling.get_ddim_sampler(tj, eps_j, SHAPE_J, OCC_J, n_steps=5))
    jevaler.uncond_gen(jax_sampler, key, 2, lambda i, x, o: want.append((x, o)))
    sample_keys, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        sample_keys.append(ddim_keys(sub))

    def key_of(name):
        top, _, rest = name.partition("/")
        return sample_keys[int(top[len("sample"):])][rest]

    evaler.uncond_gen(sampling.get_ddim_sampler(ts, eps_t, SHAPE_T, OCC_T, n_steps=5),
                      ReplayDraws(keyed_source(key_of)), 2, lambda i, x, o: got.append((x, o)))
    for (xt, ot), (xj, oj) in zip(got, want):
        close(xt, _to_t(xj), "x")
        close(ot, _to_t(oj), "occ")


def test_uncond_gen_interp_matches_jax():
    tj, ts = jsde.make_vpsde(), sde.make_vpsde()
    key = jax.random.PRNGKey(11)
    want = jevaler.uncond_gen_interp(tj, eps_j, SHAPE_J, OCC_J, key, n_pairs=2, n_interp=3, n_steps=6)
    pair_keys, k = [], key
    for _ in range(2):
        k, *ks = jax.random.split(k, 5)
        pair_keys.append(dict(zip(("z0", "z1", "zo0", "zo1"), ks)))

    def key_of(name):
        top, _, rest = name.partition("/")
        return pair_keys[int(top[len("pair"):])][rest]

    got = evaler.uncond_gen_interp(ts, eps_t, SHAPE_T, OCC_T, ReplayDraws(keyed_source(key_of)), n_pairs=2,
                                   n_interp=3, n_steps=6)
    assert len(got) == 2 and all(len(row) == 3 for row in got)
    for row_t, row_j in zip(got, want):
        for (xt, ot), (xj, oj) in zip(row_t, row_j):
            close(xt, _to_t(xj), "x")
            close(ot, _to_t(oj), "occ")
    # the interpolants differ: the slerp is used
    assert float((got[0][0][0] - got[0][2][0]).abs().max()) > 1e-2


@pytest.mark.parametrize("with_occ_condition", [False, True])
def test_cond_gen_matches_jax(with_occ_condition):
    tj, ts = jsde.make_vpsde(n=100), sde.make_vpsde(n=100)
    rng = np.random.default_rng(4)
    cond = rng.normal(size=SHAPE_J).astype(np.float32)
    cmask = (rng.uniform(size=SHAPE_J) > 0.5).astype(np.float32)
    fm = (rng.uniform(size=SHAPE_J) > 0.2).astype(np.float32)
    om = (rng.uniform(size=OCC_J) > 0.2).astype(np.float32)
    occ_cond = rng.normal(size=OCC_J).astype(np.float32) if with_occ_condition else None
    occ_cmask = (rng.uniform(size=OCC_J) > 0.5).astype(np.float32) if with_occ_condition else None
    key = jax.random.PRNGKey(13)
    xj, oj = jevaler.cond_gen(tj, eps_j, cond, cmask, key, SHAPE_J, feature_mask=fm, occ_shape=OCC_J, occ_mask=om,
                              occ_condition=occ_cond, occ_cond_mask=occ_cmask)
    tt = lambda a: None if a is None else torch.from_numpy(_to_t(a))
    xt, ot = evaler.cond_gen(ts, eps_t, tt(cond), tt(cmask), ReplayDraws(keyed_source(pc_key_of(key, 4))), SHAPE_T,
                             feature_mask=tt(fm), occ_shape=OCC_T, occ_mask=tt(om), occ_condition=tt(occ_cond),
                             occ_cond_mask=tt(occ_cmask))
    close(xt, _to_t(xj), "x")
    close(ot, _to_t(oj), "occ")


# ---------------------------------------------------------------- the zoo


@pytest.mark.parametrize("name", ["ancestral_sampling", "euler_maruyama", "reverse_diffusion"])
@pytest.mark.parametrize("t", [0, 57, 99])
def test_predictors_match_jax(name, t):
    tj, ts = jsde.make_vpsde(n=100), sde.make_vpsde(n=100)
    rng = np.random.default_rng(t)
    x, eps = (rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(t + 1)
    want = jsampling.PREDICTORS[name](tj, key, x, eps, t)
    got = sampling.PREDICTORS[name](ts, torch.from_numpy(np.array(jax.random.normal(key, x.shape))),
                                    torch.from_numpy(x), torch.from_numpy(eps), t)
    for a, b in zip(got, want):
        assert_close(a, b, rtol=1e-6, atol=1e-6, what=name)
    assert sampling.PREDICTORS["none"] is None and set(sampling.PREDICTORS) == set(jsampling.PREDICTORS)


@pytest.mark.parametrize("name", ["langevin", "ald"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_correctors_match_jax(name, n_steps):
    tj, ts = jsde.make_vpsde(n=100), sde.make_vpsde(n=100)
    x = np.random.default_rng(n_steps).normal(size=(1, 4, 4, 4, 2)).astype(np.float32)
    key, t = jax.random.PRNGKey(21), 60
    want = jsampling.CORRECTORS[name](tj, key, x, lambda xx, tt: jnp.tanh(xx) * 0.3, t, snr=0.075, n_steps=n_steps)
    keys, k = [], key
    for _ in range(n_steps):
        k, k1 = jax.random.split(k)
        keys.append(k1)
    draws = ReplayDraws(lambda kind, nm, shape, lo, hi: np.asarray(jax.random.normal(keys[int(nm[5:])], shape)))
    got = sampling.CORRECTORS[name](ts, draws, torch.from_numpy(x), lambda xx, tt: torch.tanh(xx) * 0.3, t,
                                    snr=0.075, n_steps=n_steps)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what=name)
    assert set(sampling.CORRECTORS) == set(jsampling.CORRECTORS)


def test_slerp_matches_jax():
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(2, 3, 4)).astype(np.float32), rng.normal(size=(2, 3, 4)).astype(np.float32)
    for t in (0.0, 0.3, 1.0):
        assert_close(sampling.slerp(torch.from_numpy(a), torch.from_numpy(b), t), jsampling.slerp(a, b, t),
                     rtol=1e-5, atol=1e-6, what=f"slerp {t}")


# ---------------------------------------------------------------- with the U-Net


def test_ddim_with_the_small_unet_matches_jax():
    """Three masked DDIM steps through the small U-Net of each package with
    the same weights (the sampler as ``main_diffusion`` builds it)."""
    d, rng = 8, np.random.default_rng(1)
    params = _flax_like(_flax_shapes(JConfig(**SMALL), d), rng)
    fm = (rng.uniform(size=(1, d, d, d, 4)) > 0.3).astype(np.float32)
    om = (rng.uniform(size=(1, 2 * d, 2 * d, 2 * d, 1)) > 0.3).astype(np.float32)
    jm = JUNet3D(JConfig(**SMALL))
    eps_jax = lambda x, o, t: jm.apply({"params": params}, x, o, t, feature_mask=fm, occ_mask=om)
    shape_j, occ_j = (1, d, d, d, 4), (1, 2 * d, 2 * d, 2 * d, 1)
    key = jax.random.PRNGKey(2)
    xj, oj = jax.jit(jsampling.get_ddim_sampler(jsde.make_vpsde(), eps_jax, shape_j, occ_j, n_steps=3,
                                                feature_mask=fm, occ_mask=om))(key)
    model = UNet3D(UNet3DConfig(**SMALL)).eval()
    model.load_state_dict(unet_params_from_flax(params))

    def eps_torch(x, o, t):
        with compute_policy("float32", "cpu"):
            return model(x, o, t, feature_mask=ncdhw(fm), occ_mask=ncdhw(om))

    keys = ddim_keys(key)
    xt, ot = sampling.get_ddim_sampler(sde.make_vpsde(), eps_torch, (1, 4, d, d, d), (1, 1, 2 * d, 2 * d, 2 * d),
                                       n_steps=3, feature_mask=ncdhw(fm), occ_mask=ncdhw(om))(
        ReplayDraws(keyed_source(keys.__getitem__)))
    close(xt, _to_t(xj), "x")
    close(ot, _to_t(oj), "occ")


# ---------------------------------------------------------------- likelihood and registry


def test_likelihood_gaussian_matches_jax():
    """The Gaussian case of ``tests/test_diffusion_extras.py`` (score −x):
    the replayed Rademacher probe gives JAX's estimate, and both sit near
    the analytic N(0, I) log-density."""
    tj, ts = jsde.make_vpsde(n=100), sde.make_vpsde(n=100)
    x = np.random.default_rng(6).normal(size=(2, 2, 2, 1)).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(0)
    lj, zj = jlikelihood.ode_log_likelihood(tj, lambda xx, t: -xx, jnp.asarray(x), key, n_steps=50)
    probe = (np.asarray(jax.random.rademacher(key, x.shape, dtype=jnp.float32)) + 1) // 2
    lt, zt = likelihood.ode_log_likelihood(ts, lambda xx, t: -xx, torch.from_numpy(x),
                                           ReplayDraws(lambda *a: probe.astype(np.int64)), n_steps=50)
    assert_close(zt, zj, rtol=1e-5, atol=1e-6, what="z")
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    analytic = -0.5 * x.size * np.log(2 * np.pi)
    assert abs(float(lt) - analytic) < 0.5 * x.size


def test_likelihood_divergence_uses_the_network_jacobian():
    """A score with a non-diagonal Jacobian: Hutchinson's estimate through
    ``torch.autograd.grad`` equals JAX's ``vjp`` with the same probe."""
    tj, ts = jsde.make_vpsde(n=100), sde.make_vpsde(n=100)
    x = np.random.default_rng(7).normal(size=(1, 3, 2, 2, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    lj, zj = jlikelihood.ode_log_likelihood(tj, lambda xx, t: -jnp.tanh(xx + jnp.roll(xx, 1, axis=1)) * (1 + t),
                                            jnp.asarray(x), key, n_steps=10)
    probe = (np.asarray(jax.random.rademacher(key, x.shape, dtype=jnp.float32)) + 1) // 2
    lt, zt = likelihood.ode_log_likelihood(
        ts, lambda xx, t: -torch.tanh(xx + torch.roll(xx, 1, dims=1)) * (1 + t), torch.from_numpy(x),
        ReplayDraws(lambda *a: probe.astype(np.int64)), n_steps=10)
    assert_close(zt, zj, rtol=1e-5, atol=1e-6, what="z")
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))


def test_registry_and_score_fn_match_jax():
    assert registry.create_model("unet3d_occgrid", UNet3DConfig(**SMALL)).__class__ is UNet3D

    @registry.register_model(name="dummy_port")
    class Dummy:
        pass

    assert isinstance(registry.create_model("dummy_port"), Dummy) and registry.get_model("dummy_port") is Dummy
    tj, ts = jsde.make_vpsde(n=100), sde.make_vpsde(n=100)
    rng = np.random.default_rng(2)
    x, pred = rng.normal(size=(2, 1, 2, 2, 2)).astype(np.float32), rng.normal(size=(2, 1, 2, 2, 2)).astype(np.float32)
    labels = np.array([10, 50])
    for pred_type in ("noise", "x0"):
        sj = jregistry.get_score_fn(tj, lambda p, a, b, c: (jnp.asarray(pred), jnp.asarray(pred) * 2), pred_type)
        st = registry.get_score_fn(ts, lambda a, b, c: (torch.from_numpy(pred), torch.from_numpy(pred) * 2),
                                   pred_type)
        for a, b in zip(st(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(labels)),
                        sj(None, x, x, labels)):
            assert_close(a, b, rtol=1e-5, atol=1e-6, what=pred_type)
