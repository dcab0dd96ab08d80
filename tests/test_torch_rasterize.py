"""Port rasterizer (gshell_tpu_torch.ops.rasterize) vs the JAX package.

Stage B's plain PyTorch version — the CPU twin of the hand-written CUDA
kernel — is held against the Pallas kernel run in interpret mode on the same
pair list, and the whole tiled rasterizer against JAX's Pallas backend.
Tolerance: triangle ids identical on ≥ 99.9 % of pixels; where the ids
agree, z within 1e-6 on ≥ 99 % of pixels and within 1e-5 everywhere.  Not
bit-exact because XLA:CPU contracts the edge function a·x + b·y + c into an
FMA (checked: JAX's z equals the value recomputed with fma(a, x, b·y) + c),
which moves the top-left tie test and the z tie-break by one rounding of an
edge value of up to W·H px², i.e. a few 1e-6 in z after the division by the
doubled area.  The port never contracts; on the card the kernel and the plain
version agree bit for bit (test_torch_cuda.py).
Gradients of interpolate + antialias w.r.t. clip positions: rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.ops import rasterize as jr
from gshell_tpu.ops.math import lookat, perspective, xfm_points
from gshell_tpu_torch.ops import rasterize as tr
from gshell_tpu_torch.utils.synthetic import crowded_tile_mesh
from torch_parity import assert_close, n, t

torch.set_num_threads(1)
H = W = 64


def _mesh(seed, nv=120, nf=200):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-0.6, 0.6, size=(nv, 3)).astype(np.float32)
    faces = rng.integers(0, nv, size=(nf, 3)).astype(np.int32)
    proj = perspective(np.deg2rad(45.0))
    view = lookat(jnp.array([0.0, 0.0, 2.2]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
    v_clip = np.asarray(xfm_points(jnp.asarray(verts), proj @ view))
    return v_clip, faces


def _check_z(z_port, z_jax):
    dz = np.abs(z_port.astype(np.float64) - z_jax)
    assert (dz <= 1e-6).mean() >= 0.99, f"z within 1e-6 on {(dz <= 1e-6).mean():.4f} of pixels"
    assert dz.max() <= 1e-5, f"max |dz| {dz.max()}"


def _pallas_stage_b(bins):
    """JAX ``_stage_b_pallas`` in interpret mode on the port's pair list:
    (best_z, best_id with -1 = miss) as numpy."""
    # the Pallas kernel walks (C, 16, 128) super-chunks of the same pairs
    pd = n(bins.pair_data)
    kcp = 128
    n_sc = -(-pd.shape[0] // kcp)
    pd = np.pad(pd, ((0, n_sc * kcp - pd.shape[0]), (0, 0))).reshape(n_sc, kcp, 16).transpose(0, 2, 1)
    jz, jidf = jr._stage_b_pallas(
        jnp.asarray(pd), jnp.asarray(n(bins.tile_start)), jnp.asarray(n(bins.tile_cnt)),
        bins.n_tiles, bins.tx_n, 16, kcp, interpret=True,
    )
    return np.asarray(jz), np.asarray(jidf).astype(np.int64) - 1


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_b_plain_matches_pallas(seed):
    v_clip, faces = _mesh(seed)
    bins = tr.bin_pairs(t(v_clip), t(faces).long(), (H, W))
    bz, bid = tr.stage_b_plain(bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    jz, jid = _pallas_stage_b(bins)
    pid = n(bid).astype(np.int64)
    assert (pid >= 0).sum() > 500, "mesh covers too few pixels to test"
    same = pid == jid
    assert same.mean() >= 0.999, f"ids agree on {same.mean():.5f} of pixels"
    hit = same & (pid >= 0)
    _check_z(n(bz)[hit], np.asarray(jz)[hit])


def _crowded_bins(seed):
    v_clip, faces = crowded_tile_mesh(H, seed=seed)
    bins = tr.bin_pairs(v_clip, faces, (H, W))
    assert int(bins.tile_cnt[bins.tx_n + 1]) >= 4 * tr.STAGE_B_SUB  # the crowded tile
    return bins, faces.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_b_split_merge_is_exact(seed):
    """The kernel's schedule (sub-segments of STAGE_B_SUB pairs, 64-bit key
    merge with atomicMin semantics) on one crowded tile with exact depth
    ties and ±0.0 depths: ids identical to the plain version and to the JAX
    Pallas kernel in interpret mode; depths equal to the plain version's.
    The mesh is exact in float32, so FMA contraction in XLA moves nothing."""
    bins, n_faces = _crowded_bins(seed)
    args = (bins.pair_data, bins.tile_start, bins.tile_cnt, bins.n_tiles, bins.tx_n)
    sz, sid = tr.stage_b_split_merge(*args)
    assert int((tr.stage_b_schedule(bins.tile_start, bins.tile_cnt)[:, 3] >= 4).sum()) >= 4
    pz, pid = tr.stage_b_plain(*args)
    jz, jid = _pallas_stage_b(bins)
    assert torch.equal(sid, pid)
    np.testing.assert_array_equal(n(sid).astype(np.int64), jid)
    hit = n(pid) >= 0
    assert hit.all()
    np.testing.assert_array_equal(n(sz)[hit], n(pz)[hit])
    np.testing.assert_array_equal(n(sz)[hit], jz[hit])
    crowd = n(sid)[bins.tx_n + 1]
    assert ((crowd == 0) | (crowd == 1)).sum() > 50  # the +0.0 sheet wins its pixels
    assert (crowd >= n_faces - 2).sum() == 0  # never its -0.0 duplicate


@pytest.mark.parametrize("sub", [tr.STAGE_B_SUB, 7])
def test_stage_b_schedule_covers_every_pair_once(sub):
    bins, _ = _crowded_bins(2)
    live = tr.stage_b_schedule(bins.tile_start, bins.tile_cnt, sub)
    assert live.shape[0] <= tr.stage_b_max_subs(bins.n_tiles, bins.pair_data.shape[0], sub)
    assert (live[1:, 0] >= live[:-1, 0]).all()  # tiles in order
    assert int(live[:, 2].max()) <= sub and int(live[:, 2].min()) >= 1
    covered = torch.zeros(bins.pair_data.shape[0], dtype=torch.int64)
    for tile, first, cnt, nsub in live.tolist():
        covered[first:first + cnt] += 1
        assert nsub == -(-int(bins.tile_cnt[tile]) // sub)
    want = torch.zeros_like(covered)
    for s, c in zip(bins.tile_start.tolist(), bins.tile_cnt.tolist()):
        want[s:s + c] = 1
    assert torch.equal(covered, want)
    assert (live[:, 3] > 1).any() and (live[:, 3] == 1).any()


def test_stage_b_keys_order_z_then_id():
    z = torch.tensor([-1.0, -0.5, -0.0, 0.0, 1e-30, 0.25, 1.0, 0.25, -0.0], dtype=torch.float32)
    ids = torch.tensor([9, 3, 7, 2, 0, 5, 1, 4, 1], dtype=torch.int32)
    keys = tr.pack_key(z, ids)
    order = sorted(range(len(z)), key=lambda i: (float(z[i]), int(ids[i])))
    assert torch.argsort(keys).tolist() == order
    uz, uid = tr.unpack_key(keys)
    assert torch.equal(uz, z) and torch.equal(uid, ids)  # -0.0 comes back as +0.0 (== -0.0)
    mz, mid = tr.unpack_key(torch.tensor([torch.iinfo(torch.int64).max]))
    assert float(mz) == float(torch.tensor(3.4e38)) and int(mid) == -1


def test_rasterize_tiled_matches_jax_pallas_backend():
    v_clip, faces = _mesh(2)
    rj = jr.rasterize_tiled(jnp.asarray(v_clip), jnp.asarray(faces), (H, W), tile=16,
                            backend="pallas", pallas_interpret=True)
    rt = tr.rasterize_tiled(t(v_clip), t(faces).long(), (H, W))
    ids_j, ids_t = np.asarray(rj.tri_id), n(rt.tri_id)
    same = ids_j == ids_t
    assert same.mean() >= 0.999, f"ids agree on {same.mean():.5f} of pixels"
    hit = same & (ids_t > 0)
    assert hit.sum() > 500
    _check_z(n(rt.zbuf)[hit], np.asarray(rj.zbuf)[hit])
    assert_close(n(rt.bary)[hit], np.asarray(rj.bary)[hit], rtol=0, atol=1e-5, what="bary")
    assert int(rt.dropped) == int(rj.dropped) == 0


def test_interpolate_antialias_grads_match_jax():
    """d/dv_clip of a weighted sum of interpolate + antialias outputs, with
    the same discrete raster on both sides."""
    v_clip, faces = _mesh(3, nv=80, nf=60)
    rt = tr.rasterize_tiled(t(v_clip), t(faces).long(), (H, W))
    rj = jr.Rast(tri_id=jnp.asarray(n(rt.tri_id).astype(np.int32)), bary=jnp.asarray(n(rt.bary)),
                 zbuf=jnp.asarray(n(rt.zbuf)))
    rng = np.random.default_rng(4)
    attr = rng.normal(size=(v_clip.shape[0], 5)).astype(np.float32)
    color = rng.uniform(size=(H, W, 4)).astype(np.float32)
    w_i = rng.normal(size=(H, W, 5)).astype(np.float32)
    w_a = rng.normal(size=(H, W, 4)).astype(np.float32)
    fj = jnp.asarray(faces)

    def loss_j(vc, at):
        out = jr.interpolate(at, rj, fj, v_clip=vc)
        aa = jr.antialias(jnp.asarray(color) + 0.1 * out[..., :4], rj, vc, fj)
        return jnp.sum(out * w_i) + jnp.sum(aa * w_a)

    val_j, (g_vc_j, g_at_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jnp.asarray(v_clip), jnp.asarray(attr))

    vc, at = t(v_clip, True), t(attr, True)
    ft = t(faces).long()
    out = tr.interpolate(at, rt, ft, v_clip=vc)
    aa = tr.antialias(t(color) + 0.1 * out[..., :4], rt, vc, ft)
    val_t = torch.sum(out * t(w_i)) + torch.sum(aa * t(w_a))
    val_t.backward()
    assert_close(val_t, val_j, rtol=1e-5, what="value")
    assert np.abs(n(vc.grad)).max() > 0
    assert_close(vc.grad, g_vc_j, rtol=1e-4, atol=1e-4 * np.abs(np.asarray(g_vc_j)).max(), what="d/dv_clip")
    assert_close(at.grad, g_at_j, rtol=1e-4, atol=1e-6, what="d/dattr")


def test_bary_screen_derivs_match_jax():
    v_clip, faces = _mesh(5)
    rt = tr.rasterize_tiled(t(v_clip), t(faces).long(), (H, W))
    rj = jr.Rast(tri_id=jnp.asarray(n(rt.tri_id).astype(np.int32)), bary=jnp.asarray(n(rt.bary)),
                 zbuf=jnp.asarray(n(rt.zbuf)))
    dj = jr.bary_screen_derivs(rj, jnp.asarray(faces), jnp.asarray(v_clip))
    dt = tr.bary_screen_derivs(rt, t(faces).long(), t(v_clip))
    assert_close(dt, dj, rtol=1e-4, atol=1e-6, what="rast_db")
