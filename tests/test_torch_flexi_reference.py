"""The port's FlexiCubes path against the benchmark's plain reference
(``benchmark/reference/flexi``) on the CPU, from seeded random weights.

* The extractor at voxel 8 and 12 on a sphere and on a noisy SDF whose sign
  pattern has C16/C19 ambiguous cube pairs, cut open by an mSDF plane, with
  random α / β / γ: faces, validity masks and counts exact; the values a
  valid face reads and the gradients of a weighted sum of them with respect
  to x, s, ν, α, β and γ within ``VALUES`` and ``GRAD``.
* One ``Reconstructor.train_step`` of the port, built by
  ``reconstructor_from_flags`` from a configuration with ``use_flexicubes``
  at voxel 10 and 32², against ``ReferenceFlexiReconstructor`` from the
  benchmark's inputs (the SDF MLP fitted to the skirt's solid, the mSDF
  cut, warm Adam moments) and draws: the loss within ``LOSS_RTOL``, each
  gradient group within ``GROUP_GRAD``, the port's row gathers
  (``ops/gather.py``) in its path.
* The span ``recon.flexi_extract_backward`` holds the backward node of
  every operation the extractor ran and of none that the render, the MLP
  or the losses ran; the slot counters log a step only under a profiler.

Readings on the CPU: every comparison reads 0 (the reference is a frozen
copy; the port's gathers add in aten's order on the CPU).  The limits are
the float32 round-off of another order of summation, read when the port
was held to the JAX package (``tests/test_torch_flexicubes.py``: values
3.4e-7 of their largest magnitude, normals 1.4e-3, gradients 1 − cosine
1.5e-3 and norm 8.9e-4; ``tests/test_torch_flexi_tick.py``: the loss
terms 1.58e-4), so that a change of the port that only reorders its sums
passes and one that changes what it computes does not.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.draws import KeyedDraws
from benchmark.inputs import flexi as flexi_inputs
from benchmark.inputs import reconstruction as recon_inputs
from benchmark.reference.flexi import gshell_flexicubes as ref_fc
from benchmark.reference.flexi.cube_grid import build_cube_grid as ref_build_cube_grid
from benchmark.reference.flexi.trainer import ReferenceFlexiReconstructor
from benchmark.runners.reconstruction import named_leaves
from gshell_tpu_torch.geometry import flexi_geometry
from gshell_tpu_torch.geometry.cube_grid import build_cube_grid
from gshell_tpu_torch.geometry.gshell_flexicubes import GShellFlexiCubes
from gshell_tpu_torch.ops import gather as ga
from gshell_tpu_torch.train.setup import reconstructor_from_flags
from gshell_tpu_torch.utils import spans
from gshell_tpu_torch.utils.config import load_flags

OUTPUTS = ("verts", "v_nrm", "msdf", "msdf_boundary", "l_dev")
INPUTS = ("x", "s", "nu", "beta", "alpha", "gamma")
VALUES = {"verts": 5e-7, "msdf": 5e-7, "msdf_boundary": 5e-7, "l_dev": 1.5e-6, "v_nrm": 2e-3}
GRAD = (2e-3, 1.5e-3)  # (1 − cosine ≤, relative norm difference ≤)
LOSS_RTOL = 2.5e-4
GROUP_GRAD = (2e-3, 1.5e-3)
SEED = 2 ** 31 + 1717
CONFIG = {"use_flexicubes": True, "voxel_grid": 10, "gshell_grid": 10, "train_res": [32, 32], "batch": 2,
          "n_samples": 2, "d_hidden": 32, "n_hidden": 2, "skip_in": [1], "learning_rate": [0.03, 0.005],
          "denoiser": "bilateral", "iter": 5000, "boxscale": [1, 1, 1], "aabb": [-1, -1, -1, 1, 1, 1]}
ADAM = {"step": 0, "first": 0.1, "second": [0.5, 1.5],
        "grad_rms": {"deform": 1e-4, "cube_weights": 1e-4, "msdf": 1e-4, "sdf_net": 1e-2, "tables": 1e-5,
                     "mlp": 1e-7, "light": 1e-4}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------- the extractor ----------------

def _inputs(res: int, case: str, seed: int):
    """x, s, ν and the raw weights, float32 numpy."""
    rng = np.random.default_rng(seed)
    grid = build_cube_grid(res)
    x = (grid.verts * 1.4 + rng.uniform(-0.2, 0.2, grid.verts.shape) * 1.4 / res).astype(np.float32)
    c = np.array([0.03, -0.02, 0.01], np.float32)
    s = np.linalg.norm(x - c, axis=-1) - 0.33 + 0.03 * np.sin(5.0 * x[:, 0])
    if case == "noisy":
        s = s + rng.normal(0.0, 0.08, s.shape)
    nu = x[:, 2] + 0.3 * x[:, 0] + 0.05
    n_cubes = grid.n_cubes
    weights = [rng.normal(0.0, 0.7, shape) for shape in ((n_cubes, 12), (n_cubes, 8), (n_cubes,))]
    return grid, [a.astype(np.float32) for a in [x, s, nu] + weights]


def _inverted_pairs(grid, s) -> int:
    """Flagged C16/C19 surface cubes whose face neighbour is flagged too
    (both take the complement case), counted in numpy from the tables."""
    occ = np.concatenate([s < 0, [False]])[grid.cubes]
    case = (occ * (1 << np.arange(8))).sum(-1)
    surf = occ.any(-1) & ~occ.all(-1)
    chk = ref_fc.ft.CHECK_TABLE[case]
    flagged = (chk[:, 0] == 1) & surf
    r = grid.res
    ids = np.arange(grid.n_cubes)
    adj = np.stack([ids // (r * r), (ids // r) % r, ids % r], -1) + chk[:, 1:4]
    ok = ((adj >= 0) & (adj < r)).all(-1)
    adj_id = np.clip((adj[:, 0] * r + adj[:, 1]) * r + adj[:, 2], 0, grid.n_cubes - 1)
    return int((flagged & ok & flagged[adj_id]).sum())


def _extract(extractor, arrays, training: bool, loss_w=None):
    args = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    mesh = extractor(*args[:3], beta=args[3], alpha=args[4], gamma=args[5], training=training)
    if loss_w is None:  # weights of a sum over the rows a valid face reads, from the first mesh
        rng = np.random.default_rng(3)
        used = np.zeros(mesh.verts.shape[0], bool)
        used[: mesh.n_verts_watertight] = True
        used[mesh.faces[mesh.face_valid].reshape(-1).numpy()] = True
        loss_w = {k: rng.normal(size=tuple(getattr(mesh, k).shape)).astype(np.float32) for k in OUTPUTS}
        for k in ("verts", "v_nrm", "msdf"):
            loss_w[k][~used] = 0.0
        loss_w["msdf_boundary"][~used[mesh.n_verts_watertight:]] = 0.0
        loss_w["used"] = used
    sum(torch.sum(getattr(mesh, k) * torch.from_numpy(loss_w[k])) for k in OUTPUTS).backward()
    return mesh, {k: a.grad for k, a in zip(INPUTS, args)}, loss_w


def _cos_norm(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    return float(1.0 - a @ b / max(float(na * nb), 1e-300)), float(abs(na - nb) / max(float(nb), 1e-300))


@pytest.mark.parametrize("case, res, training", [("sphere", 8, True), ("noisy", 12, True), ("noisy", 12, False)])
def test_extractor_matches_the_reference(case, res, training):
    grid, arrays = _inputs(res, case, seed=res + len(case))
    if case == "noisy":
        assert _inverted_pairs(grid, arrays[1]) > 0
    mesh, grads, w = _extract(GShellFlexiCubes(grid, "cpu"), arrays, training)
    ref, ref_grads, _ = _extract(ref_fc.GShellFlexiCubes(ref_build_cube_grid(res), "cpu"), arrays, training, w)
    assert int(mesh.n_surf_cubes) > 0 and bool(mesh.face_valid.any())
    assert 0 < int(mesh.face_valid.sum()) < int(mesh.face_wt_valid.sum()) * 2  # the plane cuts faces away
    for k in ("faces", "face_valid", "faces_wt", "face_wt_valid", "n_surf_cubes", "n_crossing_edges",
              "n_quad_edges"):
        assert torch.equal(getattr(mesh, k), getattr(ref, k)), k
    assert mesh.n_verts_watertight == ref.n_verts_watertight
    used = torch.from_numpy(w["used"])
    rows = {"verts": used, "v_nrm": used, "msdf": used, "msdf_boundary": used[mesh.n_verts_watertight:]}
    for k, limit in VALUES.items():
        a, b = getattr(mesh, k).detach(), getattr(ref, k).detach()
        if k in rows:
            a, b = a[rows[k]], b[rows[k]]
        err = float(torch.max(torch.abs(a - b))) / max(float(torch.max(torch.abs(b))), 1e-30)
        assert err <= limit, (k, err)
    for k in INPUTS:
        cos, norm = _cos_norm(grads[k], ref_grads[k])
        assert cos <= GRAD[0] and norm <= GRAD[1], (k, cos, norm)


# ---------------- one train step ----------------

@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    """(configuration path, flags, parameters, targets) of a tiny FlexiCubes
    scene made by the benchmark's inputs."""
    path = str(tmp_path_factory.mktemp("flexi") / "flexi.json")
    with open(path, "w") as f:
        json.dump(CONFIG, f)
    flags = load_flags(path)
    torch.manual_seed(0)
    params = flexi_inputs.make_params(flags, SEED, "cpu", fit_steps=100, fit_points=2048)
    targets = recon_inputs.render_targets(flags, SEED, "cpu", n_views=2, cam_radius=3.0, fovy_deg=45.0)
    return path, flags, params, targets


def _step(rec, params, targets):
    """One train step from the tiny cell's state → (loss, {leaf: gradient})."""
    geo, mat, light = params
    state = rec.make_state(geo, mat, light, step=1000)
    leaves = named_leaves(state.params_geo, state.params_mat, state.light_base)
    recon_inputs.warm_adam(state.optimizers, leaves, SEED, ADAM)
    m = rec.train_step(state, KeyedDraws(SEED, "cpu", "step0"), recon_inputs.batch(targets, SEED, 0, 2))
    return float(m["total"]), {k: t.grad.detach().clone() for k, t in leaves.items()}, m


def test_a_train_step_matches_the_reference(tiny_cell):
    path, flags, params, targets = tiny_cell
    seen, logged = ga.gather_stats()["rows_seen"], len(flexi_geometry.slot_counts())
    loss, grads, m = _step(reconstructor_from_flags(flags, "cpu"), params, targets)
    assert ga.gather_stats()["rows_seen"] > seen  # the port's row gathers ran in the step
    assert len(flexi_geometry.slot_counts()) == logged  # the slot counters log only under a profiler
    assert int(m["n_surf_cubes"]) > 0 and int(m["n_faces"]) > 0
    assert int(m["cube_slot_overflow"]) == int(m["edge_slot_overflow"]) == int(m["face_cap_overflow"]) == 0
    ref_loss, ref_grads, _ = _step(ReferenceFlexiReconstructor(path, "cpu"), params, targets)
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), (loss, ref_loss)
    assert set(grads) == set(ref_grads) and "cube_weights" in grads
    groups = {}
    for k in grads:
        groups.setdefault(k.split(".")[0].rstrip("0123456789"), []).append(k)
    assert set(groups) == {"deform", "cube_weights", "msdf", "sdf_net", "tables", "mlp", "light"}
    for g, keys in groups.items():
        a = torch.cat([grads[k].reshape(-1) for k in keys])
        b = torch.cat([ref_grads[k].reshape(-1) for k in keys])
        assert float(torch.linalg.vector_norm(b)) > 0, g
        cos, norm = _cos_norm(a, b)
        assert cos <= GROUP_GRAD[0] and norm <= GROUP_GRAD[1], (g, cos, norm)


# ---------------- the backward span ----------------

def test_the_backward_span_holds_the_extractors_backward_and_nothing_else(tiny_cell):
    """Every backward node whose forward operation ran inside
    ``recon.flexi_extract`` runs inside a ``recon.flexi_extract_backward``
    record, and none whose forward ran elsewhere (the lattice MLP, the
    render, the losses) does; the profiler links a node to its forward by
    their sequence number.  The step logs its slot counts."""
    _, flags, params, targets = tiny_cell
    rec = reconstructor_from_flags(flags, "cpu")
    known, logged = {r.id for r in spans.recorded()}, len(flexi_geometry.slot_counts())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, m = _step(rec, params, targets)
    ext = rec.geo.extractor
    (row,) = flexi_geometry.slot_counts()[logged:]
    assert {k: v for k, v in row.items() if k != "time_ns"} == {
        "surface_cubes": int(m["n_surf_cubes"]), "max_cubes": ext.max_cubes, "quad_edges": int(m["n_quad_edges"]),
        "max_edges": ext.max_edges, "faces": int(m["n_faces"]), "face_cap": rec.geo.face_cap}
    records = [r for r in spans.recorded() if r.id not in known]

    def intervals(name):
        return [(r.start_ns, r.end_ns) for r in records if r.name == name]

    def inside(t, iv):
        return any(s <= t <= e for s, e in iv)

    fwd, bwd = intervals("recon.flexi_extract"), intervals("recon.flexi_extract_backward")
    assert len(fwd) == 1 and bwd
    events = prof.profiler.kineto_results.events()
    seq_in, seq_out = set(), set()
    for e in events:
        if e.name().startswith("aten::") and e.sequence_nr() >= 0:
            (seq_in if inside(e.start_ns(), fwd) else seq_out).add(e.sequence_nr())
    nodes = [e for e in events if "Backward" in e.name() and not e.name().startswith("autograd::")
             and e.sequence_nr() >= 0]
    ours = [e for e in nodes if e.sequence_nr() in seq_in - seq_out]
    others = [e for e in nodes if e.sequence_nr() in seq_out - seq_in]
    assert len(ours) > 50 and len(others) > 500
    assert {e.name() for e in ours} >= {"TanhBackward0", "SigmoidBackward0"}
    assert [e.name() for e in ours if not inside(e.start_ns(), bwd)] == []
    assert [e.name() for e in others if inside(e.start_ns(), bwd)] == []
    assert "SoftplusBackward0" in {e.name() for e in others}  # the lattice MLP stays outside
