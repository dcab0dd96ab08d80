"""Port bilateral denoiser (gshell_tpu_torch.ops.denoiser) vs the JAX package.

The plain PyTorch stencil — the CPU twin of the hand-written CUDA kernel — is
held against the jnp twin ``_accumulate`` and the Pallas kernel in interpret
mode, for the forward and the transposed (denom_from_tap) stencil, and the
autograd denoiser against JAX's custom VJP (value and colour gradient).
r = 5 at 24×40 with rtol 2e-5 / atol 1e-6, the tolerance of
tests/test_denoiser_pallas.py, for positive colours: the port rounds the
normal dot product without FMA (XLA:CPU contracts it) and ^128 turns that one
ulp into ~128 ulp of the tap weight, which stays inside 2e-5 relative when
all terms are positive.  With signed inputs (gradients) the cancelling sums
turn the same weight error into absolute error, so those checks use atol 1e-5
on values of order 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.ops import denoiser as jd
from gshell_tpu_torch.ops import denoiser as td
from torch_parity import assert_close, t

torch.set_num_threads(1)
R = 5
H, W = 24, 40
TOL = dict(rtol=2e-5, atol=1e-6)
TOL_SIGNED = dict(rtol=2e-5, atol=1e-5)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    col = rng.uniform(size=(H, W, 3)).astype(np.float32)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    z = rng.uniform(size=(H, W, 1)) * 3.0 + 1.0
    dz = rng.uniform(size=(H, W, 1)) * 0.5 + 0.1
    return col, nrm, np.concatenate([z, dz], -1).astype(np.float32)


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("sigma", [2.0, 0.7])
def test_forward_matches_jax(reference, sigma):
    col, nrm, zdz = _inputs(0)
    args = (jnp.asarray(col), jnp.asarray(nrm), jnp.asarray(zdz), jnp.asarray(sigma))
    if reference == "jnp":
        ref_c, ref_w = jd._accumulate(*args, R)
    else:
        ref_c, ref_w = jd._accumulate_pallas(*args, R, interpret=True, th=8)
    acc_c, acc_w = td.bilateral_accumulate(t(col), t(nrm), t(zdz), sigma, R)
    assert_close(acc_w, ref_w, **TOL, what="acc_w")
    assert_close(acc_c, ref_c, **TOL, what="acc_col")


def _jax_bwd_loop(gp, nrm, zdz, sigma, r):
    """The XLA branch of ops.denoiser._bwd (the transposed stencil)."""
    variance = sigma * sigma
    pad = lambda a: jnp.pad(a, ((r, r), (r, r), (0, 0)))
    gpp, nrmp, zdzp = pad(gp), pad(nrm), pad(zdz)
    maskp = pad(jnp.ones((H, W, 1)))

    def body(i, acc):
        fy = i // (2 * r + 1) - r
        fx = i % (2 * r + 1) - r
        sl = lambda a: jax.lax.dynamic_slice(a, (r - fy, r - fx, 0), (H, W, a.shape[-1]))
        wgt = jd._tap_weight(sl(nrmp), sl(zdzp), nrm, zdz, fx, fy, variance) * sl(maskp)
        return acc + sl(gpp) * wgt

    return jax.lax.fori_loop(0, (2 * r + 1) ** 2, body, jnp.zeros_like(gp))


@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_transposed_stencil_matches_jax(reference):
    col, nrm, zdz = _inputs(1)
    gp = np.random.default_rng(9).normal(size=(H, W, 3)).astype(np.float32)
    sigma = 1.5
    if reference == "jnp":
        ref = _jax_bwd_loop(jnp.asarray(gp), jnp.asarray(nrm), jnp.asarray(zdz), jnp.asarray(sigma), R)
    else:
        ref, _ = jd._accumulate_pallas(jnp.asarray(gp), jnp.asarray(nrm), jnp.asarray(zdz),
                                       jnp.asarray(sigma), R, denom_from_tap=True,
                                       interpret=True, th=8)
    out, _ = td.bilateral_accumulate(t(gp), t(nrm), t(zdz), sigma, R, denom_from_tap=True)
    assert_close(out, ref, **TOL_SIGNED, what="transposed stencil")


def test_denoiser_value_and_colour_grad_match_jax_vjp():
    col, nrm, zdz = _inputs(2)
    nrm = nrm * 1.7  # unnormalized on purpose: both sides normalize inside
    g = np.random.default_rng(3).normal(size=(H, W, 3)).astype(np.float32)
    sigma = 2.0
    out_j, vjp = jax.vjp(lambda c: jd.bilateral_denoiser(c, jnp.asarray(nrm), jnp.asarray(zdz),
                                                         jnp.asarray(sigma), R), jnp.asarray(col))
    (g_col_j,) = vjp(jnp.asarray(g))
    c = t(col, True)
    n_t, z_t = t(nrm, True), t(zdz, True)
    out_t = td.bilateral_denoiser(c, n_t, z_t, sigma, R)
    out_t.backward(t(g))
    assert_close(out_t, out_j, **TOL, what="denoised")
    assert_close(c.grad, g_col_j, **TOL_SIGNED, what="d/dcol")
    assert n_t.grad is None and z_t.grad is None  # weights are constants


def test_six_channel_denoiser_matches_two_jax_calls():
    """The renderer denoises diffuse and specular, which share their guides,
    in one 6-channel call: value and colour gradient against two JAX
    ``bilateral_denoiser`` calls of 3 channels each."""
    col, nrm, zdz = _inputs(4)
    col2 = np.random.default_rng(6).uniform(size=(H, W, 3)).astype(np.float32) * 2.0
    g = np.random.default_rng(7).normal(size=(H, W, 6)).astype(np.float32)
    sigma = 2.0
    outs, grads = [], []
    for c, gc in ((col, g[..., 0:3]), (col2, g[..., 3:6])):
        out_j, vjp = jax.vjp(lambda x: jd.bilateral_denoiser(x, jnp.asarray(nrm), jnp.asarray(zdz),
                                                             jnp.asarray(sigma), R), jnp.asarray(c))
        outs.append(np.asarray(out_j))
        grads.append(np.asarray(vjp(jnp.asarray(gc))[0]))
    c6 = t(np.concatenate([col, col2], -1), True)
    out_t = td.bilateral_denoiser(c6, t(nrm), t(zdz), sigma, R)
    out_t.backward(t(g))
    assert out_t.shape == (H, W, 6)
    assert_close(out_t, np.concatenate(outs, -1), **TOL, what="denoised")
    assert_close(c6.grad, np.concatenate(grads, -1), **TOL_SIGNED, what="d/dcol")


def test_six_channel_stencil_equals_two_three_channel_calls():
    """Each channel sums its taps alone: one 6-channel call equals two
    3-channel calls bit for bit, forward and transposed."""
    col, nrm, zdz = _inputs(5)
    col2 = np.random.default_rng(8).normal(size=(H, W, 3)).astype(np.float32)
    for from_tap in (False, True):
        c6, w6 = td.bilateral_accumulate(t(np.concatenate([col, col2], -1)), t(nrm), t(zdz), 1.3, R,
                                         denom_from_tap=from_tap)
        a, wa = td.bilateral_accumulate(t(col), t(nrm), t(zdz), 1.3, R, denom_from_tap=from_tap)
        b, _ = td.bilateral_accumulate(t(col2), t(nrm), t(zdz), 1.3, R, denom_from_tap=from_tap)
        assert torch.equal(c6, torch.cat([a, b], -1))
        assert torch.equal(w6, wa)
