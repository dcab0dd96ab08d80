"""The port's FlexiCubes extractor vs the JAX package's, slot for slot.

Voxel grids 8 and 12; a perturbed sphere, a noisy SDF whose sign pattern
has C16/C19 ambiguous cube pairs, an open cut by an mSDF plane, a random
mSDF, random per-cube weights α / β / γ (and none), the training 4-triangle
split and the eval diagonal split, and the QEF dual vertices through an
analytic SDF gradient.  Both packages run each case in float64 and in
float32.

Faces, validity masks and counts are compared exactly.  In float64 the
function itself is held: vertices, normals, the mSDF and ``msdf_boundary``
of the rows a valid face reads (:func:`_used_rows`) and L_dev to 1e-6
relative, the gradients of a weighted sum of them with respect to x, s, ν,
α, β and γ to 1e-5 relative of each gradient's largest element (readings:
~1e-13).  In float32 the two packages sum in other orders (and XLA fuses
multiply-adds), and the function amplifies that round-off where it is ill
conditioned: the QEF's 3×3 systems (the 1e-3 regularizer against nearly
parallel normals), the normals of sliver triangles a cut leaves, and the
ν crossings of nearly equal ν; those runs are held to ``F32_*`` limits set
from readings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.geometry.cube_grid import build_cube_grid as j_build_cube_grid
from gshell_tpu.geometry.flexicubes_tables import CHECK_TABLE
from gshell_tpu.geometry.gshell_flexicubes import GShellFlexiCubes as JGShellFlexiCubes
from gshell_tpu_torch.geometry.cube_grid import build_cube_grid
from gshell_tpu_torch.geometry.gshell_flexicubes import GShellFlexiCubes
from torch_parity import assert_close, cosine_and_norm, n, t

torch.set_num_threads(1)
CENTER = np.array([0.03, -0.02, 0.01], np.float32)
OUTPUTS = ("verts", "v_nrm", "msdf", "msdf_boundary", "l_dev")
INPUTS = ("x", "s", "nu", "beta", "alpha", "gamma")


def _sdf(p, lib):
    c = lib.asarray(CENTER) if lib is jnp else torch.as_tensor(CENTER)
    norm = jnp.linalg.norm(p - c, axis=-1) if lib is jnp else torch.linalg.norm(p - c, dim=-1)
    return norm - 0.33 + 0.03 * lib.sin(5.0 * p[..., 0])


def _sdf_grad(p, lib):
    c = lib.asarray(CENTER) if lib is jnp else torch.as_tensor(CENTER)
    d = p - c
    if lib is jnp:
        g = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return g.at[..., 0].add(0.15 * jnp.cos(5.0 * p[..., 0]))
    g = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return g + torch.stack([0.15 * torch.cos(5.0 * p[..., 0]), 0 * p[..., 0], 0 * p[..., 0]], -1)


def _inputs(res, case, seed):
    """x, s, ν and the raw weights (or None) as numpy float32."""
    rng = np.random.default_rng(seed)
    grid = build_cube_grid(res)
    x = (grid.verts * 1.4 + rng.uniform(-0.2, 0.2, grid.verts.shape) * 1.4 / res).astype(np.float32)
    s = np.asarray(_sdf(torch.as_tensor(x), torch)).astype(np.float32)
    if case == "noisy":
        s = s + rng.normal(0.0, 0.08, s.shape).astype(np.float32)
    nu = {"sphere": np.ones_like(s), "noisy": x[:, 2] + 0.3 * x[:, 0] + 0.05,
          "cut": x[:, 2] + 0.3 * x[:, 0] + 0.05, "random_nu": rng.uniform(-1.0, 1.0, s.shape),
          "qef": x[:, 1] - 0.2 * x[:, 2] + 0.02}[case].astype(np.float32)
    c = grid.n_cubes
    if case == "sphere":
        weights = (None, None, None)
    else:
        weights = tuple(rng.normal(0.0, 0.7, shape).astype(np.float32) for shape in ((c, 12), (c, 8), (c,)))
    return grid, x, s, nu, weights


def _used_rows(mesh):
    """Vertex rows that matter: the watertight block and the boundary vertices
    of valid cut faces.  The other boundary slots extrapolate ν along face
    edges that do not cross 0 (as in the JAX function) and are never read;
    their round-off is amplified by 1 / (ν_u − ν_w) and means nothing."""
    used = np.zeros(np.shape(mesh.verts)[0], bool)
    used[: mesh.n_verts_watertight] = True
    used[np.asarray(mesh.faces)[np.asarray(mesh.face_valid)].ravel()] = True
    return used


def _loss_weights(mesh, seed):
    rng = np.random.default_rng(seed)
    w = {k: rng.normal(size=np.shape(getattr(mesh, k))).astype(np.float32) for k in OUTPUTS}
    used = _used_rows(mesh)
    for k in ("verts", "v_nrm", "msdf"):
        w[k][~used] = 0.0
    w["msdf_boundary"][~used[mesh.n_verts_watertight:]] = 0.0
    return w


def _loss(mesh, w, lib):
    total = 0.0
    for k in OUTPUTS:
        total = total + (getattr(mesh, k) * (lib.asarray(w[k]) if lib is jnp else torch.as_tensor(w[k]))).sum()
    return total


CASES = [
    ("sphere", 8, True, False), ("sphere", 12, False, False),
    ("noisy", 12, True, False), ("noisy", 12, False, False),
    ("cut", 12, True, False), ("cut", 8, False, False),
    ("random_nu", 12, True, False), ("random_nu", 12, False, False),
    ("qef", 12, True, True), ("qef", 12, False, True),
]


# float32: each output's max |error| over its largest magnitude (ν's for
# the boundary ν), and each gradient's 1 − cosine and relative norm
# difference, about 1.5× the worst readings over CASES on the CPU: verts
# 3.4e-7 (QEF 1.25e-4), msdf 2.7e-7, msdf_boundary 2.6e-8, l_dev 1.0e-6,
# normals 1.4e-3; gradients 1 − cosine 1.5e-3, norm 8.9e-4 (random ν).
F32_VALUES = {"verts": 5e-7, "msdf": 5e-7, "msdf_boundary": 5e-8, "l_dev": 1.5e-6, "v_nrm": 2e-3}
F32_QEF_VERTS = 2e-4
F32_GRAD = (2e-3, 1.5e-3)


def _run(case, res, training, qef, dtype):
    grid, x, s, nu, weights = _inputs(res, case, seed=res + len(case))
    arrs = [a.astype(dtype) if a is not None else None for a in (x, s, nu) + weights]
    present = [i for i, a in enumerate(arrs) if a is not None]
    ext_t = GShellFlexiCubes(grid, "cpu")
    t_args = [torch.from_numpy(a).requires_grad_(True) if a is not None else None for a in arrs]
    gf = (lambda p: _sdf_grad(p, torch)) if qef else None
    mt = ext_t(*t_args[:3], beta=t_args[3], alpha=t_args[4], gamma=t_args[5], training=training, grad_func=gf)
    w = _loss_weights(jax.tree_util.tree_map(lambda v: n(v) if isinstance(v, torch.Tensor) else v, mt), seed=3)
    _loss(mt, w, torch).backward()
    grads_t = {INPUTS[i]: t_args[i].grad for i in present}

    with jax.enable_x64(dtype == np.float64):
        ext_j = JGShellFlexiCubes(j_build_cube_grid(res))
        gf_j = (lambda p: _sdf_grad(p, jnp)) if qef else None
        j_args = [jnp.asarray(a) if a is not None else None for a in arrs]

        def loss_j(*vals):  # one compile for the mesh and the gradients
            args = list(j_args)
            for i, v in zip(present, vals):
                args[i] = v
            mesh = ext_j(*args[:3], beta=args[3], alpha=args[4], gamma=args[5], training=training, grad_func=gf_j)
            return _loss(mesh, w, jnp), mesh

        run = jax.jit(jax.grad(loss_j, argnums=tuple(range(len(present))), has_aux=True))
        grads_j, mj = run(*[j_args[i] for i in present])
        mj = jax.tree_util.tree_map(np.asarray, mj)
        grads_j = {INPUTS[i]: np.asarray(g) for i, g in zip(present, grads_j)}
    assert (ext_t.max_cubes, ext_t.max_edges) == (ext_j.max_cubes, ext_j.max_edges)
    return ext_t, mj, mt, grads_j, grads_t


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case, res, training, qef", CASES)
def test_flexicubes_extractor_matches_jax(case, res, training, qef, dtype):
    ext_t, mj, mt, grads_j, grads_t = _run(case, res, training, qef, dtype)
    for k in ("faces", "face_valid", "faces_wt", "face_wt_valid"):
        np.testing.assert_array_equal(n(getattr(mt, k)), getattr(mj, k), err_msg=k)
    for k in ("n_surf_cubes", "n_crossing_edges"):
        assert int(getattr(mt, k)) == int(getattr(mj, k)), k
    assert mt.n_verts_watertight == mj.n_verts_watertight
    assert int(mt.n_surf_cubes) > 0 and int(mt.face_valid.sum()) > 0
    assert int(mt.n_surf_cubes) <= ext_t.max_cubes and int(mt.n_quad_edges) <= ext_t.max_edges
    if case != "sphere":
        assert np.abs(mj.msdf_boundary).max() > 0  # the mSDF cuts the surface

    used = _used_rows(mj)
    rows = {"verts": used, "msdf": used, "v_nrm": used, "msdf_boundary": used[mj.n_verts_watertight:],
            "l_dev": ...}
    for k in OUTPUTS:
        a, d = n(getattr(mt, k))[rows[k]], getattr(mj, k)[rows[k]]
        if dtype == np.float64:
            assert_close(a, d, rtol=1e-6, atol=1e-12, what=k)
        else:
            # a boundary vertex's ν is a crossing of ν (≈ 0): it errs on ν's scale
            scale = np.abs(mj.msdf).max() if k == "msdf_boundary" else np.abs(d).max()
            limit = F32_QEF_VERTS if (qef and k == "verts") else F32_VALUES[k]
            assert_close(a, d, rtol=0.0, atol=limit * scale, what=k)

    for k, gj in grads_j.items():
        gt = grads_t[k]
        assert np.isfinite(gj).all() and torch.isfinite(gt).all(), k
        assert np.abs(gj).max() > 0, f"d/d{k} is zero"
        if dtype == np.float64:
            assert_close(gt, gj, rtol=1e-5, atol=1e-5 * np.abs(gj).max(), what=f"d/d{k}")
        else:
            cos, dnorm = cosine_and_norm(gt, gj)
            assert 1 - cos <= F32_GRAD[0] and dnorm <= F32_GRAD[1], f"d/d{k}: cosine {cos}, norm {dnorm}"


def test_noisy_case_has_ambiguous_pairs_that_invert():
    """The noisy SDF reaches the C16/C19 inversion: some flagged surface cube
    has a flagged face neighbour (counted in numpy from the tables)."""
    grid, _, s, _, _ = _inputs(12, "noisy", seed=12 + len("noisy"))
    occ = np.concatenate([s < 0, [False]])[grid.cubes]
    case = (occ * (1 << np.arange(8))).sum(-1)
    surf = occ.any(-1) & ~occ.all(-1)
    chk = CHECK_TABLE[case]
    flagged = (chk[:, 0] == 1) & surf
    r = grid.res
    ids = np.arange(grid.n_cubes)
    adj = np.stack([ids // (r * r), (ids // r) % r, ids % r], -1) + chk[:, 1:4]
    ok = ((adj >= 0) & (adj < r)).all(-1)
    adj_id = np.clip((adj[:, 0] * r + adj[:, 1]) * r + adj[:, 2], 0, grid.n_cubes - 1)
    assert (flagged & ok & flagged[adj_id]).sum() > 0


def test_full_slots_truncate_and_report_as_in_jax():
    """Capacities below the counts: both sides truncate to the same slots,
    and the port's counts show the truncation."""
    grid, x, s, nu, weights = _inputs(12, "cut", seed=15)
    mj = JGShellFlexiCubes(j_build_cube_grid(12), 80, 80)(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(nu), *[jnp.asarray(a) for a in weights])
    mt = GShellFlexiCubes(grid, "cpu", 80, 80)(t(x), t(s), t(nu), *[t(a) for a in weights])
    np.testing.assert_array_equal(n(mt.faces), np.asarray(mj.faces))
    used = _used_rows(mj)
    assert_close(mt.verts[used], np.asarray(mj.verts)[used], rtol=1e-6, atol=1e-7, what="verts")
    assert int(mt.n_surf_cubes) > 80 and int(mt.n_quad_edges) > 80


def _nodes_to(outputs):
    """The autograd nodes reachable from ``outputs``: their class names, and
    the leaves their ``AccumulateGrad`` nodes feed."""
    names, leaves, seen = [], [], set()
    todo = [o.grad_fn for o in outputs if o.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        if names[-1] == "AccumulateGrad":
            leaves.append(node.variable)
        todo.extend(f for f, _ in node.next_functions)
    return names, leaves


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_flexicubes_gathers_take_the_row_gather_backward(training):
    """Between the extractor's outputs and all six inputs, no gather is left
    on aten's ``IndexBackward0`` (whose backward on the card sorts the padded
    slots' runs on the sentinel rows): each is ``ops.gather.gather_rows``,
    12 in the extractor (α's two corners, β with γ, x / s / ν at both edge
    ends, the quad corners, the cut's six) and 3 in the vertex normals."""
    grid, x, s, nu, weights = _inputs(8, "cut", seed=8 + len("cut"))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, s, nu) + weights]
    mesh = GShellFlexiCubes(grid, "cpu")(*args[:3], beta=args[3], alpha=args[4], gamma=args[5], training=training)
    names, leaves = _nodes_to([getattr(mesh, k) for k in OUTPUTS])
    assert "IndexBackward0" not in names
    assert names.count("_GatherRowsBackward") == 15
    assert {id(v) for v in leaves} == {id(a) for a in args}
