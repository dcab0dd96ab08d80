"""Port material and shading (hash grid, MLP texture, env light, MC shading,
shadow field) vs the JAX package, with the JAX random draws replayed into
the port by name.

Tolerances: hash grid forward and gradients rtol 1e-5 (same gathers and
products, sums in another order); env_shade values and input gradients
rtol 1e-4 (long chains of transcendental functions whose CPU
implementations differ by an ulp or two between XLA and PyTorch); the
shadow field's bits are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.geometry import mlp as jmlp
from gshell_tpu.ops import hashgrid as jhg
from gshell_tpu.ops import math as jm
from gshell_tpu.ops import shade as jsh
from gshell_tpu.render import light as jlt
from gshell_tpu_torch.geometry import mlp as tmlp
from gshell_tpu_torch.ops import hashgrid as thg
from gshell_tpu_torch.ops import shade as tsh
from gshell_tpu_torch.render import light as tlt
from gshell_tpu_torch.utils.rng import ReplayDraws
from torch_parity import assert_close, n, shade_source, t

torch.set_num_threads(1)

HG_J = jhg.HashGridConfig(n_levels=4, log2_table_size=10, base_resolution=4, desired_resolution=64)
HG_T = thg.HashGridConfig(n_levels=4, log2_table_size=10, base_resolution=4, desired_resolution=64)


def _tables(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.1, 0.1, size=(HG_J.n_levels, HG_J.table_size, 2)).astype(np.float32)


def test_hashgrid_encode_exact_matches_jax():
    tables = _tables(0)
    x = np.random.default_rng(1).uniform(size=(300, 3)).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(300, HG_J.out_dim)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda tb, xx: jhg.hashgrid_encode(jhg.HashGridParams(tb), xx, HG_J),
                         jnp.asarray(tables), jnp.asarray(x))
    g_tab_j, g_x_j = vjp(jnp.asarray(g))
    tb, xx = t(tables, True), t(x, True)
    out_t = thg.hashgrid_encode(tb, xx, HG_T)
    out_t.backward(t(g))
    assert_close(out_t, out_j, rtol=1e-5, atol=1e-7, what="encode")
    assert_close(tb.grad, g_tab_j, rtol=1e-5, atol=1e-6, what="d/dtables")
    assert_close(xx.grad, g_x_j, rtol=1e-5, atol=1e-5, what="d/dx")


def test_hashgrid_encode_stochastic_matches_jax():
    """Exact fp16-table forward, x gradients through the saved position
    Jacobian, table gradients through the same replayed subset ``sel``."""
    tables = _tables(3)
    p, frac = 400, 0.25
    x = np.random.default_rng(4).uniform(size=(p, 3)).astype(np.float32)
    g = np.random.default_rng(5).normal(size=(p, HG_J.out_dim)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    out_j, vjp = jax.vjp(
        lambda tb, xx: jhg.hashgrid_encode_stochastic(jhg.HashGridParams(tb), xx, HG_J, key, frac),
        jnp.asarray(tables), jnp.asarray(x))
    g_tab_j, g_x_j = vjp(jnp.asarray(g))
    draws = ReplayDraws(lambda kind, name, shape, lo, hi: np.asarray(
        jax.random.randint(key, shape, lo, hi)))
    tb, xx = t(tables, True), t(x, True)
    out_t = thg.hashgrid_encode_stochastic(tb, xx, HG_T, draws, frac)
    out_t.backward(t(g))
    assert_close(out_t, out_j, rtol=1e-5, atol=1e-7, what="encode")
    assert_close(tb.grad, g_tab_j, rtol=1e-5, atol=1e-6, what="d/dtables")
    assert_close(xx.grad, g_x_j, rtol=1e-5, atol=1e-5, what="d/dx")


def test_sdf_mlp_matches_jax():
    cfg_j = jmlp.MLPConfig(n_freq=4, d_hidden=32, n_hidden=3, skip_in=(1,))
    cfg_t = tmlp.MLPConfig(n_freq=4, d_hidden=32, n_hidden=3, skip_in=(1,))
    params = jax.tree_util.tree_map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(0), cfg_j))
    x = np.random.default_rng(6).uniform(-0.7, 0.7, size=(64, 3)).astype(np.float32)
    ref = jmlp.apply_mlp(params, jnp.asarray(x), cfg_j)
    out = tmlp.apply_mlp({k: [t(a) for a in v] for k, v in params.items()}, t(x), cfg_t)
    assert_close(out, ref, rtol=1e-5, atol=1e-6, what="sdf mlp")


def _light(seed, h=16, w=32):
    base = np.random.default_rng(seed).uniform(0.25, 0.75, size=(h, w, 3)).astype(np.float32)
    lj = jlt.update_pdf(jnp.asarray(base))
    return base, lj


def _light_t(base_t, lj):
    return tlt.EnvLight(base=base_t, pdf=t(lj.pdf), rows=t(lj.rows), cols=t(lj.cols))


def test_sample_light_matches_jax():
    base, lj = _light(7)
    rng = np.random.default_rng(8)
    u, v = (rng.uniform(size=(500,)).astype(np.float32) for _ in range(2))
    dj, pj = jlt.sample_light(lj, jnp.asarray(u), jnp.asarray(v))
    dt, pt = tlt.sample_light(_light_t(t(base), lj), t(u), t(v))
    assert_close(dt, dj, rtol=1e-5, atol=1e-6, what="dirs")
    assert_close(pt, pj, rtol=1e-4, atol=1e-6, what="pdf")


def _occupancy(res=33, n_pts=4000, seed=9):
    """Surface splat of a sphere of radius 0.45 into a [-0.7, 0.7]³ lattice."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_pts, 3))
    pts = 0.45 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    ijk = np.clip(((pts + 0.7) / 1.4 * (res - 1)).astype(np.int64), 0, res - 1)
    occ = np.zeros((res, res, res), np.float32)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = 1.0
    return occ, (-0.7, -0.7, -0.7), (1.4, 1.4, 1.4)


def test_shadow_field_matches_jax():
    occ, amin, asz = _occupancy()
    cfg_j, consts = jsh.make_shadow_field_parts(jnp.asarray(occ), amin, asz, ko=8)
    vis_t = tsh.make_shadow_field(t(occ), amin, asz, ko=8)
    bits_j = np.asarray(jax.lax.bitcast_convert_type(consts["field"], jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(n(vis_t.field), bits_j.reshape(-1))
    assert n(vis_t.field).any()
    rng = np.random.default_rng(10)
    ro = rng.uniform(-0.3, 0.3, size=(2000, 3)).astype(np.float32)
    rd = rng.normal(size=(2000, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    vj = jsh.apply_visibility(cfg_j, consts, jnp.asarray(ro), jnp.asarray(rd))
    vt = tsh.apply_visibility(vis_t, t(ro), t(rd))
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    assert 0 < n(vt).mean() < 1


def _shade_inputs(p=256, seed=12):
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)
    gb_pos = f(rng.uniform(-0.4, 0.4, size=(p, 3)))
    nrm = rng.normal(size=(p, 3))
    nrm = f(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
    view = f(np.tile([[0.0, 0.0, 2.5]], (p, 1)))
    nrm = np.where(np.sum(nrm * (view - gb_pos), -1, keepdims=True) < 0, -nrm, nrm)  # face the camera
    kd = f(rng.uniform(0.1, 0.9, size=(p, 3)))
    # roughness ≥ 0.4: a sharper GGX lobe turns the ulp-level differences of
    # sin/cos between XLA and PyTorch in the sampled directions into
    # percent-level differences of single specular samples
    ks = f(np.stack([np.zeros(p), rng.uniform(0.4, 1.0, p), rng.uniform(0.0, 1.0, p)], -1))
    mask = f((rng.uniform(size=(p, 1)) < 0.9))
    return mask, f(gb_pos + nrm * 1e-3), gb_pos, f(nrm), view, kd, ks


@pytest.mark.parametrize("light_bf16", [False, True])
def test_env_shade_matches_jax(light_bf16):
    """env_shade with the mesh-splat shadow field, replayed draws: values and
    gradients w.r.t. normals, kd, ks and the light, with the light texel read
    in f32 and in bf16 (the main path).  The bf16 texel's cotangent is
    accumulated in bf16 on both sides; measured max relative error of d/dlight
    4.5e-5 (bf16) and 7.8e-4 (f32, on an element far below the atol)."""
    mask, ro, gb_pos, nrm, view, kd, ks = _shade_inputs()
    base, lj = _light(13)
    occ, amin, asz = _occupancy()
    vis_j = jsh.make_shadow_field_parts(jnp.asarray(occ), amin, asz, ko=8)
    vis_t = tsh.make_shadow_field(t(occ), amin, asz, ko=8)
    key = jax.random.PRNGKey(21)
    kw = dict(n_samples_x=2, bsdf="pbr", shadow_scale=0.7, light_pool=64, mc_block=2,
              light_bf16=light_bf16)
    rng = np.random.default_rng(14)
    gd, gs = (rng.normal(size=(mask.shape[0], 3)).astype(np.float32) for _ in range(2))

    def fj(nr, kd_, ks_, b):
        light = jlt.EnvLight(base=b, pdf=lj.pdf, rows=lj.rows, cols=lj.cols)
        out = jsh.env_shade(key, jnp.asarray(mask), jnp.asarray(ro), jnp.asarray(gb_pos), nr,
                            jnp.asarray(view), kd_, ks_, light, visibility_fn=vis_j, **kw)
        return out.diffuse, out.specular

    (dj, sj), vjp = jax.vjp(fj, jnp.asarray(nrm), jnp.asarray(kd), jnp.asarray(ks), jnp.asarray(base))
    g_j = vjp((jnp.asarray(gd), jnp.asarray(gs)))

    leaves = [t(a, True) for a in (nrm, kd, ks, base)]
    out = tsh.env_shade(ReplayDraws(shade_source(key)), t(mask), t(ro), t(gb_pos), leaves[0],
                        t(view), leaves[1], leaves[2], _light_t(leaves[3], lj),
                        visibility=vis_t, **kw)
    assert_close(out.diffuse, dj, rtol=1e-4, atol=1e-6, what="diffuse")
    assert_close(out.specular, sj, rtol=1e-4, atol=1e-6, what="specular")
    assert np.abs(n(out.diffuse)).max() > 0
    (torch.sum(out.diffuse * t(gd)) + torch.sum(out.specular * t(gs))).backward()
    for name, leaf, gj in zip(("d/dnormal", "d/dkd", "d/dks", "d/dlight"), leaves, g_j):
        gj = np.asarray(gj)
        assert_close(leaf.grad, gj, rtol=1e-4, atol=1e-5 * max(np.abs(gj).max(), 1e-6), what=name)


class _Maximum0(torch.autograd.Function):
    """max(x, 0) with ``jnp.maximum(0, x)``'s derivative (the cotangent
    times 1, ½ at a tie, 0 below): the port's rule before ``sqrt_nonneg``,
    under which sqrt's infinite derivative at 0 became ∞ or NaN."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))


def test_sqrt_nonneg_matches_jax_where_finite():
    """``sqrt_nonneg``'s forward equals the port's former
    ``sqrt(clamp(x, 0))`` bit for bit and ``jnp.sqrt(jnp.maximum(0, x))``
    to the ulp by which XLA's and PyTorch's CPU square roots differ; its
    derivative equals JAX's where x > 0 (to that ulp) and is 0 where JAX's
    is infinite (x = 0) or NaN (x < 0).  (No subnormal x: XLA's CPU flushes
    them to 0.)"""
    from gshell_tpu_torch.ops.math import sqrt_nonneg

    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-1e-6, 1e-6, 500), rng.uniform(-1, 1, 500), [0.0, -0.0]])
    x = x.astype(np.float32)
    y_j, g_j = jax.vmap(jax.value_and_grad(lambda v: jnp.sqrt(jnp.maximum(0.0, v))))(jnp.asarray(x))
    xt = t(x, True)
    y_t = sqrt_nonneg(xt)
    y_t.sum().backward()
    np.testing.assert_array_equal(n(y_t), n(torch.sqrt(torch.clamp(t(x), min=0.0))))
    assert_close(y_t, y_j, rtol=2.4e-7, what="forward")
    g_j, g_t = np.asarray(g_j), n(xt.grad)
    assert np.isfinite(g_t).all()
    pos = x > 0
    assert_close(g_t[pos], g_j[pos], rtol=2.4e-7, what="derivative where x > 0")
    assert (g_t[~pos] == 0).all() and not np.isfinite(g_j[~pos]).any()


def _jax_rim_argument(alpha, wo, ux, uy):
    """The argument a = 1 − p1² − p2² of JAX's ``sqrt(max(0, a))`` in
    ``_sample_ggx_vndf``, by the same jnp operations in the same order.
    Outside ``jit`` each runs on its own, as they do under the test's
    un-jitted ``jax.grad``, so the values are JAX's."""
    alpha, wo = jnp.asarray(alpha), jnp.asarray(wo)
    vh = jm.safe_normalize(jnp.concatenate([alpha * wo[..., 0:1], alpha * wo[..., 1:2], wo[..., 2:3]], -1))
    r = jnp.sqrt(jnp.clip(jnp.asarray(ux), 0.0, 1.0))[..., None]
    phi = (2.0 * np.pi) * jnp.asarray(uy)[..., None]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2:3])
    p2 = (1.0 - s) * jnp.sqrt(jnp.clip(1.0 - p1 * p1, 0.0, 1.0)) + s * p2
    return np.asarray(1.0 - p1 * p1 - p2 * p2)[..., 0]


def test_vndf_nonfinite_gradients_match_jax(monkeypatch):
    """GGX-VNDF samples near the rim of the disk (r → 1), where the
    argument a = 1 − p1² − p2² of ``sqrt(max(0, a))`` rounds to 0 or below:
    JAX's derivative there is infinite or NaN.  The port's
    ``sqrt_nonneg`` keeps the forward bit for bit and is finite on every
    sample (ROADMAP C: a deliberate difference); under JAX's rule the port's
    gradient is non-finite where JAX's is, up to the samples whose a lands
    on the other side of 0 on the two sides.

    Held exactly: each side's non-finite samples are the samples where that
    side's own a ≤ 0, and where both sides' a lie on the same side of 0 the
    two sets agree.  Bounded: a differs between the sides by round-off only
    (p1, p2 come from cos and sin, which the two CPU math libraries round
    differently by an ulp: |Δa| ≤ 8 ulp(1)), so the samples that flip are
    those whose a lies within 8 ulp(1) of 0 on both sides.  Gradients
    where both are finite: rtol 1e-3 (long chains of elementary functions)
    plus, per sample, twice the first-order relative effect of |Δa| on the
    rim's derivative 1/(2√a), |Δa|/(2a) with a the smaller of the two
    sides' (on an "AMD EPYC" host a sample with a of round-off size read
    768.5 against JAX's 852.9)."""
    rng = np.random.default_rng(15)
    p = 20000
    wo = rng.normal(size=(p, 3))
    wo[:, 2] = np.abs(wo[:, 2])
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    alpha = rng.uniform(0.0064, 1.0, size=(p, 1)).astype(np.float32)
    ux = (1.0 - rng.uniform(0.0, 1e-6, size=(p,))).astype(np.float32)
    uy = rng.uniform(size=(p,)).astype(np.float32)
    gh = rng.normal(size=(p, 3)).astype(np.float32)
    gp = rng.normal(size=(p, 1)).astype(np.float32)

    def fj(a, w):
        h, pdf = jsh._sample_ggx_vndf(a, w, jnp.asarray(ux), jnp.asarray(uy))
        return jnp.sum(h * gh) + jnp.sum(pdf * gp)

    _, gw_j = jax.grad(fj, argnums=(0, 1))(jnp.asarray(alpha), jnp.asarray(wo))
    arg_j = _jax_rim_argument(alpha, wo, ux, uy)

    def port():
        a_t, w_t = t(alpha, True), t(wo, True)
        h, pdf = tsh._sample_ggx_vndf(a_t, w_t, t(ux), t(uy))
        (torch.sum(h * t(gh)) + torch.sum(pdf * t(gp))).backward()
        return n(h), n(pdf), n(w_t.grad)

    h_t, pdf_t, g_t = port()
    seen = []

    def jax_rule(x):
        seen.append(n(x)[..., 0].copy())
        return torch.sqrt(_Maximum0.apply(x))

    monkeypatch.setattr(tsh, "sqrt_nonneg", jax_rule)
    h_r, pdf_r, g_r = port()
    (arg_t,) = seen
    np.testing.assert_array_equal(h_t, h_r)
    np.testing.assert_array_equal(pdf_t, pdf_r)
    bad_j = ~np.isfinite(np.asarray(gw_j)).all(-1)
    bad_r = ~np.isfinite(g_r).all(-1)
    assert bad_j.sum() > 0 and bad_r.sum() > 0
    np.testing.assert_array_equal(bad_j, arg_j <= 0)
    np.testing.assert_array_equal(bad_r, arg_t <= 0)
    same = (arg_j <= 0) == (arg_t <= 0)
    np.testing.assert_array_equal(bad_j[same], bad_r[same])
    gap = float(np.abs(arg_j.astype(np.float64) - arg_t).max())
    assert gap <= 8 * np.finfo(np.float32).eps, gap
    assert np.isfinite(g_t).all(), int((~np.isfinite(g_t)).sum())
    ok = ~bad_j & ~bad_r
    np.testing.assert_array_equal(g_t[ok], g_r[ok])

    gj = np.asarray(gw_j)[ok]
    rim = (gap / np.minimum(arg_j, arg_t)[ok])[:, None]  # twice |Δa|/(2a), the rim's relative spread
    assert_close(g_t[ok], gj, rtol=1e-3, atol=1e-3 * np.abs(gj).max() + rim * np.abs(gj), what="d/dwo where finite")
