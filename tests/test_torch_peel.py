"""The port's scan rasterizer, its binned second layer and its pair budget
against the JAX package, on the CPU.

* ``rasterize`` / ``rasterize_peel`` (n_layers 1–3) against JAX's: triangle
  ids identical on every pixel, zbuf within 1e-6, bary within 1e-5.  The
  scenes are exact in float32 (clip w = 1, screen positions and depths on a
  dyadic grid), so every edge value a·x + b·y + c is exact on both sides
  and XLA:CPU's FMA contraction (``tests/test_torch_rasterize.py``) moves
  neither coverage nor the top-left rule; they hold three overlapping
  layers, both windings, a degenerate face, exact duplicates (ties that the
  first index wins) and pixel centres on shared edges.  A perspective
  scene (two nested spheres) is held to identical ids too; there the
  contraction moves an edge value near 0 by a rounding of its terms (up to
  W·H px²), which the division by a small doubled area turns into up to
  ~1e-5 in z, so its zbuf is held within 3e-5 (largest reading 1.0e-5 in
  layers 1–3) and its bary within 1e-4.
* ``rasterize_tiled_peel`` (stage B's layer and the second over the same
  tile segments) against the scan's first two layers: pixels whose ids
  differ are counted,
  and each must be a tie within rounding — the two candidates' scan depths
  within ``TIE_TOL`` — since stage B computes depth as depth_num·(1/area)
  and the scan as Σ (e_k/area)·z_k.
* the binned peel runs stage A and stage B once, its second layer taking
  stage B's winners, and the renderer's two layers share that one pass.
* ``max_pairs`` against JAX's XLA backend with a per-tile cap above every
  tile's count: ids, zbuf, bary and ``dropped`` exact.
* ``render_mesh`` at a resolution off the 16-pixel tile grid takes the scan,
  as JAX's does, and matches it with the JAX draws replayed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.ops import rasterize as jr
from gshell_tpu.ops.math import lookat, perspective, xfm_points
from gshell_tpu_torch.ops import rasterize as tr
from gshell_tpu_torch.utils.synthetic_gt import sphere
from torch_parity import assert_close, n, t

torch.set_num_threads(1)
H, W = 48, 40
TIE_TOL = 1e-6  # |Δz| of two candidates that stage B and the scan may order differently


def exact_layers(seed: int, nx: int = 6, n_layers: int = 3):
    """(v_clip (V, 4), faces (F, 3)) exact in float32: ``n_layers`` tilted
    grids of nx × nx cells at distinct depths, each cell split along an
    alternating diagonal, some faces wound the other way, a few exact
    duplicates and one degenerate face."""
    rng = np.random.default_rng(seed)
    verts, faces = [], []
    for layer in range(n_layers):
        k = np.arange(nx + 1)
        gx, gy = np.meshgrid(k, k, indexing="ij")
        span = 52 + 4 * layer  # grid extent in 1/64 ndc
        x = (-span / 2 + gx * span / nx + rng.integers(-2, 3, gx.shape)) / 64.0
        y = (-span / 2 + gy * span / nx + rng.integers(-2, 3, gy.shape)) / 64.0
        z = (-32 + 24 * layer + gx - gy) / 64.0
        base = len(verts)
        verts += [(x[i, j], y[i, j], z[i, j], 1.0) for i in range(nx + 1) for j in range(nx + 1)]
        for i in range(nx):
            for j in range(nx):
                a, b = base + i * (nx + 1) + j, base + (i + 1) * (nx + 1) + j
                c, d = b + 1, a + 1
                tris = [(a, b, c), (a, c, d)] if (i + j) % 2 else [(a, b, d), (b, c, d)]
                faces += [tr_ if rng.random() < 0.7 else tr_[::-1] for tr_ in tris]
    faces = np.asarray(faces, np.int64)
    dup = rng.choice(len(faces), 8, replace=False)
    faces = np.concatenate([faces, faces[dup], [[0, 0, 1]]])
    return np.asarray(verts, np.float32), faces.astype(np.int32)


def nested_spheres():
    """Two nested spheres under a perspective camera (up to four layers)."""
    v, f = sphere(12, 8)
    verts = np.concatenate([v * 0.8, v * 0.45 + np.float32([0.1, 0.0, 0.1])]).astype(np.float32)
    faces = np.concatenate([f, f + len(v)]).astype(np.int32)
    view = lookat(jnp.array([0.3, 0.4, 2.2]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    v_clip = np.asarray(xfm_points(jnp.asarray(verts), perspective(np.deg2rad(45.0)) @ view))
    return v_clip, faces


SCENES = {"exact0": lambda: exact_layers(0), "exact1": lambda: exact_layers(1), "spheres": nested_spheres}


def _hold_layer(rt, rj, what, exact: bool = True):
    ids_t, ids_j = n(rt.tri_id).astype(np.int64), np.asarray(rj.tri_id).astype(np.int64)
    np.testing.assert_array_equal(ids_t, ids_j, err_msg=f"{what}: ids")
    hit = ids_j > 0
    zt, zj = n(rt.zbuf)[hit].astype(np.float64), np.asarray(rj.zbuf)[hit]
    assert_close(zt, zj, rtol=0, atol=1e-6 if exact else 3e-5, what=f"{what}: zbuf")
    assert (n(rt.zbuf)[~hit] == np.asarray(rj.zbuf)[~hit]).all()
    assert_close(n(rt.bary)[hit], np.asarray(rj.bary)[hit], rtol=0, atol=1e-5 if exact else 1e-4,
                 what=f"{what}: bary")
    return int(hit.sum())


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_rasterize_peel_matches_jax(scene, n_layers):
    v_clip, faces = SCENES[scene]()
    chunk = 64  # not a divisor of F: the last chunk is padded
    lj = jr.rasterize_peel(jnp.asarray(v_clip), jnp.asarray(faces), (H, W), chunk=chunk, n_layers=n_layers)
    lt = tr.rasterize_peel(t(v_clip), t(faces).long(), (H, W), chunk=chunk, n_layers=n_layers)
    assert len(lt) == n_layers
    hits = [_hold_layer(a, b, f"{scene} layer {k + 1}", exact=scene != "spheres")
            for k, (a, b) in enumerate(zip(lt, lj))]
    assert hits[-1] > 100, f"layer {n_layers} covers {hits[-1]} px: too few to test"


def test_rasterize_matches_jax_and_breaks_ties_by_first_index():
    v_clip, faces = exact_layers(2)
    rj = jr.rasterize(jnp.asarray(v_clip), jnp.asarray(faces), (H, W), chunk=32)
    rt = tr.rasterize(t(v_clip), t(faces).long(), (H, W), chunk=32)
    _hold_layer(rt, rj, "rasterize")
    # a duplicate face (index ≥ the originals) never wins the first layer,
    # and lies right behind its original in the second
    n_orig = faces.shape[0] - 9
    ids = n(rt.tri_id) - 1
    assert not (ids >= n_orig).any()
    l2 = n(tr.rasterize_peel(t(v_clip), t(faces).long(), (H, W), n_layers=2)[1].tri_id) - 1
    dup = l2 >= n_orig
    assert dup.sum() > 0
    np.testing.assert_array_equal(faces[l2[dup]], faces[ids[dup]])


def peel_differences(binned, scan, v_clip, faces, h, w):
    """(pixels whose ids differ, of them the ties within TIE_TOL)."""
    d = tr.layer_differences(binned, scan, v_clip, faces, tol=TIE_TOL)
    return d["differ"], d["ties"]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_binned_layers_match_the_scan(scene):
    """Stage B's two layers over the tile segments against the scan's (at
    48 × 48: the binned pass needs a multiple of 16): every differing pixel
    is a depth tie within rounding; on the exact scenes none differs."""
    v_clip, faces = SCENES[scene]()
    res = (H, H)
    vt, ft = t(v_clip), t(faces).long()
    scan = tr.rasterize_peel(vt, ft, res, n_layers=2)
    binned = tr.rasterize_tiled_peel(vt, ft, res)
    assert int(binned[0].dropped) == 0 and (n(binned[1].tri_id) > 0).sum() > 100
    first = tr.rasterize_tiled(vt, ft, res)
    np.testing.assert_array_equal(n(first.tri_id), n(binned[0].tri_id))
    for k in range(2):
        n_diff, n_tie = peel_differences(binned[k], scan[k], vt, ft, *res)
        assert n_diff == n_tie, f"layer {k + 1}: {n_diff} ids differ, {n_tie} of them ties"
        if scene.startswith("exact"):
            assert n_diff == 0
        same = n(binned[k].tri_id) == n(scan[k].tri_id)
        hit = same & (n(scan[k].tri_id) > 0)
        assert_close(n(binned[k].zbuf)[hit], n(scan[k].zbuf)[hit], rtol=0, atol=1e-6, what=f"layer {k + 1} z")


def test_binned_second_layer_near_ties_are_counted():
    """Two copies of a grid, the second shifted in depth by one ulp-scale
    step: stage B and the scan may order the pair either way, and every
    pixel where they differ is counted as a tie."""
    v, f = exact_layers(3, n_layers=1)
    v2 = v.copy()
    v2[:, 2] = np.nextafter(v2[:, 2], np.float32(1.0))
    v_clip = np.concatenate([v, v2])
    faces = np.concatenate([f, f + len(v)])
    vt, ft = t(v_clip), t(faces).long()
    scan = tr.rasterize_peel(vt, ft, (H, H), n_layers=2)
    binned = tr.rasterize_tiled_peel(vt, ft, (H, H))
    for k in range(2):
        n_diff, n_tie = peel_differences(binned[k], scan[k], vt, ft, H, H)
        assert n_diff == n_tie
    # the second layer is a copy of the first layer's face (the other
    # grid's, or an exact duplicate in the same grid)
    l1, l2 = n(binned[0].tri_id) - 1, n(binned[1].tri_id) - 1
    hit = l1 >= 0
    np.testing.assert_array_equal(faces[l2[hit]] % len(v), faces[l1[hit]] % len(v))


def test_binned_peel_bins_once_and_takes_stage_b_winners(monkeypatch):
    """``rasterize_tiled_peel`` runs stage A once and stage B once; the second
    layer excludes exactly stage B's winners.  ``render_mesh`` with
    ``n_layers=2`` hands that layer on (``rast_second``) to
    ``render_second_layer``, which rasterizes nothing."""
    from gshell_tpu_torch.render import render as tren
    from gshell_tpu_torch.render.light import create_trainable_env_rnd
    from gshell_tpu_torch.render.material import MLPTexture3DConfig, default_kd_ks_min_max, init_mlp_texture
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.utils.rng import TorchDraws

    calls, seen = {"bin_pairs": 0, "rasterize_stage_b": 0, "stage_b_second": 0}, {}

    def counted(name, real):
        def run(*args, **kw):
            calls[name] += 1
            seen[name] = args
            return real(*args, **kw)
        return run

    for name in calls:
        monkeypatch.setattr(tr, name, counted(name, getattr(tr, name)))
    v_clip, faces = nested_spheres()
    vt, ft = t(v_clip), t(faces).long()
    layers = tr.rasterize_tiled_peel(vt, ft, (H, H))
    assert calls == {"bin_pairs": 1, "rasterize_stage_b": 1, "stage_b_second": 1}
    bins = tr.bin_pairs(vt, ft, (H, H))
    _, id1 = tr.stage_b_plain(bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    assert torch.equal(seen["stage_b_second"][-1], id1)
    assert int(layers[1].dropped) == 0 and (n(layers[1].tri_id) > 0).sum() > 100

    v, f = sphere(12, 8)
    mat = MLPTexture3DConfig(hash=HashGridConfig(n_levels=4, log2_table_size=10), internal_dims=16,
                             min_max=default_kd_ks_min_max())
    draws = TorchDraws(torch.Generator().manual_seed(0))
    params = init_mlp_texture(draws.child("mat"), mat, "cpu")
    light = create_trainable_env_rnd(draws.child("light"), 16)
    mvp = t(np.asarray(perspective(np.deg2rad(45.0)) @ lookat(jnp.array([0.3, 0.4, 2.2]), jnp.zeros(3),
                                                               jnp.array([0.0, 1.0, 0.0]))))
    campos = torch.tensor([0.3, 0.4, 2.2])
    flags = tren.RenderFlags(resolution=(H, H), n_samples=2, use_denoiser=False)
    for k in calls:
        calls[k] = 0
    with torch.no_grad():
        buf = tren.render_mesh(draws.child("view"), t(v), t(f).long(), t(v), None, params, mat, mvp, campos, light,
                               flags, n_layers=2)
        rast2 = buf.pop("rast_second")
        out = tren.render_second_layer(draws.child("second"), t(v), t(f).long(), t(v), params, mat, mvp, campos,
                                       light, flags, rast2)
    assert calls == {"bin_pairs": 1, "rasterize_stage_b": 1, "stage_b_second": 1}
    np.testing.assert_array_equal(n(out["invdepth_second"])[..., 0] > 0, n(rast2.tri_id) > 0)


@pytest.mark.parametrize("max_pairs", [900, 1200, 1500, 2000])
def test_max_pairs_drops_and_counts_on_the_uncapped_stage_b(max_pairs):
    """The default stage B with a small pair buffer: the pairs past it are
    dropped and counted as JAX's do, and the image equals JAX's XLA backend
    with a per-tile cap above every tile's count; the binned peel drops the
    same pairs and counts them once, in its first layer.  The scene is exact
    (three 16 × 16-cell layers): its depths tie only between exact
    duplicates."""
    v_clip, faces = exact_layers(5, nx=16)
    rj = jr.rasterize_tiled(jnp.asarray(v_clip), jnp.asarray(faces), (H, H), max_pairs=max_pairs,
                            max_per_tile=4096, backend="xla")
    rt = tr.rasterize_tiled(t(v_clip), t(faces).long(), (H, H), max_pairs=max_pairs)
    _hold_layer(rt, rj, "max_pairs")
    assert int(rt.dropped) == int(rj.dropped) > 0
    peel = tr.rasterize_tiled_peel(t(v_clip), t(faces).long(), (H, H), max_pairs=max_pairs)
    assert int(peel[0].dropped) == int(rj.dropped) and int(peel[1].dropped) == 0
    np.testing.assert_array_equal(n(peel[0].tri_id), n(rt.tri_id))


def test_render_mesh_takes_the_scan_off_the_tile_grid():
    """At 40 × 24 (not a multiple of 16) ``render_mesh`` rasterizes with the
    scan, as JAX's does; with the JAX draws replayed the coverage is equal
    and the G-buffers agree at the render tolerance (rtol 1e-4)."""
    from gshell_tpu.render.light import create_trainable_env_rnd as j_env_rnd
    from gshell_tpu.render.material import MLPTexture3DConfig as JMatConfig
    from gshell_tpu.render.material import default_kd_ks_min_max, init_mlp_texture
    from gshell_tpu.ops.hashgrid import HashGridConfig as JHashGridConfig
    from gshell_tpu.render.render import RenderFlags as JRenderFlags
    from gshell_tpu.render.render import render_mesh as j_render_mesh
    from gshell_tpu_torch import convert
    from gshell_tpu_torch.ops.hashgrid import HashGridConfig
    from gshell_tpu_torch.render.light import update_pdf
    from gshell_tpu_torch.render.material import MLPTexture3DConfig
    from gshell_tpu_torch.render.render import RenderFlags, render_mesh
    from gshell_tpu_torch.utils.rng import ReplayDraws
    from torch_parity import _draw, view_key_for

    res = (40, 24)
    v, f = sphere(12, 8)
    nrm = v.copy()
    hash_kw = dict(n_levels=4, log2_table_size=10)
    mat_j = JMatConfig(channels=6, hash=JHashGridConfig(**hash_kw), min_max=default_kd_ks_min_max())
    mat_t = MLPTexture3DConfig(channels=6, hash=HashGridConfig(**hash_kw), min_max=default_kd_ks_min_max())
    params_j = init_mlp_texture(jax.random.PRNGKey(43), mat_j)
    light_j = j_env_rnd(jax.random.PRNGKey(42), 32)
    mvp = np.asarray(perspective(np.deg2rad(45.0), res[1] / res[0]) @ lookat(
        jnp.array([0.0, 0.5, 2.5]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])))
    campos = np.float32([0.0, 0.5, 2.5])
    key = jax.random.PRNGKey(7)
    kw = dict(resolution=res, n_samples=2, use_denoiser=True)
    bj = jax.jit(lambda k, vv, ff, nn, pm, m, c, lt: j_render_mesh(
        k, vv, ff, nn, None, pm, mat_j, m, c, lt, JRenderFlags(**kw), shadow_scale=0.0))(
        key, jnp.asarray(v), jnp.asarray(f), jnp.asarray(nrm), params_j, jnp.asarray(mvp), jnp.asarray(campos),
        light_j)
    draws = ReplayDraws(lambda kind, name, shape, lo, hi: _draw(kind, view_key_for(key, name), shape, lo, hi))
    bt = render_mesh(draws, t(v), t(f).long(), t(nrm), None, convert.params_mat_from_jax(params_j, "cpu"),
                     mat_t, t(mvp), t(campos), update_pdf(torch.as_tensor(np.array(light_j.base))),
                     RenderFlags(**kw), shadow_scale=0.0)
    np.testing.assert_array_equal(n(bt["mask"]), np.asarray(bj["mask"]))
    assert n(bt["mask"]).sum() > 100
    for k in ("invdepth", "normal", "kd"):
        assert_close(bt[k], bj[k], rtol=1e-4, atol=1e-5, what=k)
    # shaded: a Monte-Carlo sample of one pixel flips on the round-off of
    # the two frameworks and the denoiser spreads it (as in
    # tests/test_torch_dataset_mesh.py); readings: mean 7.2e-7, max 1.07e-3,
    # 1 pixel off by > 1e-3
    err = np.abs(n(bt["shaded"]).astype(np.float64) - np.asarray(bj["shaded"]))
    assert err.mean() <= 1.1e-6 and err.max() <= 1.6e-3 and (err.max(-1) > 1e-3).sum() <= 2, (
        err.mean(), err.max(), int((err.max(-1) > 1e-3).sum()))
