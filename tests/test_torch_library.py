"""Library pieces of the port that no entry point calls, as in the JAX
package, against the JAX functions: the mesh regularizers
(``image_grad`` with JAX's shift draw replayed, ``avg_edge_length``,
``laplace_regularizer_const`` with and without a face mask,
``normal_consistency``), the extractor's tangent frames
(``GShellTets(compute_tangents=True)``, here with a lazy mSDF evaluator as
well) and the leaf math of ``ops/math`` (``lerp``, ``cross``, ``reinhard``,
``psnr_to_mse``, ``translate``, ``rotate_y``, ``xfm_vectors``).

Values to rtol 1e-5 / atol 1e-6 and gradients to rtol 1e-4 / atol 1e-6
(the same arithmetic; sums in another order), the tangents and their
gradient as their test says; ``image_grad`` and the matrices exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.geometry.gshell_tets import GShellTets as JGShellTets
from gshell_tpu.geometry.tet_grid import build_tet_grid
from gshell_tpu.ops import math as jm
from gshell_tpu.render import regularizer as jreg
from gshell_tpu_torch.geometry.gshell_tets import GShellTets
from gshell_tpu_torch.ops import math as tm
from gshell_tpu_torch.render import regularizer as treg
from gshell_tpu_torch.utils.rng import ReplayDraws
from gshell_tpu_torch.utils.synthetic_gt import sphere
from torch_parity import _draw, assert_close, cosine_and_norm, n, t

torch.set_num_threads(1)


def _mesh(pad: int = 0):
    """A sphere with its vertices jittered, and ``pad`` degenerate padding
    faces at the end (masked out by the face mask)."""
    v, f = sphere(12, 8)
    v = (np.asarray(v) + np.random.default_rng(0).normal(0.0, 0.02, np.shape(v))).astype(np.float32)
    f = np.asarray(f, np.int64)
    if pad:
        f = np.concatenate([f, np.zeros((pad, 3), np.int64)])
    mask = np.arange(len(f)) < len(f) - pad
    return v, f, mask


@pytest.mark.parametrize("name, masked", [("avg_edge_length", False), ("laplace_regularizer_const", False),
                                          ("laplace_regularizer_const", True), ("normal_consistency", False),
                                          ("normal_consistency", True)])
def test_mesh_regularizer_matches_jax(name, masked):
    v, f, mask = _mesh(pad=7 if masked else 0)
    kw_j = {"face_mask": jnp.asarray(mask)} if masked else {}
    kw_t = {"face_mask": torch.as_tensor(mask)} if masked else {}
    fn_j, fn_t = getattr(jreg, name), getattr(treg, name)
    want, g_want = jax.value_and_grad(lambda p: fn_j(p, jnp.asarray(f, jnp.int32), **kw_j))(jnp.asarray(v))
    v_t = t(v, True)
    got = fn_t(v_t, torch.as_tensor(f), **kw_t)
    got.backward()
    assert float(want) > 0
    assert_close(got, want, rtol=1e-5, atol=1e-7, what=name)
    assert_close(v_t.grad, g_want, rtol=1e-4, atol=1e-6, what=f"d{name}/dv")


@pytest.mark.parametrize("std", [0.01, 0.1])
def test_image_grad_matches_jax(std):
    key = jax.random.PRNGKey(3)
    buf = np.random.default_rng(1).uniform(size=(2, 40, 32, 4)).astype(np.float32)
    want = jreg.image_grad(key, jnp.asarray(buf), std=std)
    draws = ReplayDraws(lambda kind, name, shape, lo, hi: _draw(kind, key, shape, lo, hi))
    got = treg.image_grad(draws, t(buf), std=std)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_extractor_tangents_and_lazy_msdf_match_jax():
    """``compute_tangents``: template normals over the template faces, their
    orthonormal-basis tangents, carried through the cut; ``msdf_fn`` gives
    the mSDF at the crossing-edge ends as ``sdf_fn`` gives the SDF."""
    grid = build_tet_grid(10)
    rng = np.random.default_rng(1)
    pos = (np.asarray(grid.verts) + rng.uniform(-0.01, 0.01, np.shape(grid.verts))).astype(np.float32)
    sdf_j = lambda p: 0.38 - jnp.linalg.norm(p, axis=-1) + 0.03 * jnp.sin(5.0 * p[..., 0])
    sdf_t = lambda p: 0.38 - torch.linalg.norm(p, dim=-1) + 0.03 * torch.sin(5.0 * p[..., 0])
    msdf_j = lambda p: p[..., 2] + 0.3 * p[..., 0] + 0.05
    msdf_t = lambda p: p[..., 2] + 0.3 * p[..., 0] + 0.05
    sdf = np.asarray(sdf_j(jnp.asarray(pos)))
    msdf = np.asarray(msdf_j(jnp.asarray(pos)))
    ext_j = JGShellTets(grid)
    out_j = lambda p: ext_j(p, jnp.asarray(sdf), jnp.asarray(msdf), compute_aug_normals=False,
                            compute_tangents=True, sdf_fn=sdf_j, msdf_fn=msdf_j)
    mj = out_j(jnp.asarray(pos))
    w = np.sin(np.arange(mj.v_tng.size, dtype=np.float32)).reshape(mj.v_tng.shape)
    g_j = jax.grad(lambda p: jnp.sum(out_j(p).v_tng * w))(jnp.asarray(pos))
    p_t = t(pos, True)
    mt = GShellTets(grid, "cpu")(p_t, t(sdf), t(msdf), sdf_fn=sdf_t, msdf_fn=msdf_t, compute_tangents=True)
    np.testing.assert_array_equal(n(mt.faces), np.asarray(mj.faces))
    assert int(mt.face_valid.sum()) > 0 and np.abs(np.asarray(mj.msdf_boundary)).max() > 0
    for what in ("verts", "msdf", "msdf_boundary"):
        assert_close(getattr(mt, what), getattr(mj, what), rtol=1e-5, atol=1e-6, what=what)
    # the basis divides by 1 + |n_z|-ish terms that amplify the smooth
    # normals' summation-order round-off: worst reading 1.94e-5
    assert_close(mt.v_tng, mj.v_tng, rtol=1e-5, atol=3e-5, what="v_tng")
    torch.sum(mt.v_tng * t(w)).backward()
    # a few rows near the basis's pole differ by up to 4e-4 relative; over all
    # rows the reading is cosine 1 − 1.9e-11, relative norm difference 1.0e-6
    cos, dnorm = cosine_and_norm(p_t.grad, g_j)
    assert cos >= 1 - 3e-11 and dnorm <= 1.5e-6, (cos, dnorm)
    assert GShellTets(grid, "cpu")(t(pos), t(sdf), t(msdf)).v_tng is None


def test_math_library_matches_jax():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=(5, 7, 3)).astype(np.float32) for _ in range(3))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    pos = rng.uniform(0.0, 5.0, size=(6,)).astype(np.float32)
    assert_close(tm.lerp(t(a), t(b), t(c)), jm.lerp(a, b, c), rtol=1e-6, atol=1e-7, what="lerp")
    assert_close(tm.cross(t(a), t(b[:1])), jm.cross(jnp.asarray(a), jnp.asarray(b[:1])), rtol=1e-5, atol=1e-6,
                 what="cross")
    assert_close(tm.reinhard(t(np.abs(a))), jm.reinhard(np.abs(a)), rtol=1e-6, atol=0, what="reinhard")
    assert_close(tm.psnr_to_mse(t(pos * 10)), jm.psnr_to_mse(jnp.asarray(pos * 10)), rtol=1e-6, what="psnr_to_mse")
    np.testing.assert_array_equal(n(tm.translate(0.5, -1.25, 2.0)), np.asarray(jm.translate(0.5, -1.25, 2.0)))
    np.testing.assert_array_equal(n(tm.rotate_y(0.7)), np.asarray(jm.rotate_y(0.7)))
    assert_close(tm.xfm_vectors(t(a), t(m)), jm.xfm_vectors(jnp.asarray(a), jnp.asarray(m)), rtol=1e-5, atol=1e-6,
                 what="xfm_vectors")
