"""The port's ``DatasetNeRFColmap`` and ``DatasetLLFF`` against the JAX
package's, on fixtures this test writes: PNG frames and masks, a Colmap
``transforms.json`` (a camera angle per frame) and an LLFF
``poses_bounds.npy``.  ``mvp`` and ``campos`` to rtol 1e-6 / atol 1e-6
(numpy on both sides), the premultiplied images exactly (the same 8-bit
decode and sRGB curve).

The frames are written at the training resolution: JAX's loaders
premultiply a resized image in place, which fails on the read-only array
its resize returns (ROADMAP C); the port's resize is checked on its own.
Masks are RGB, since JAX's loader reads a grey mask's first column
(ROADMAP C).  A JPEG frame raises in the port, which decodes PNG and .hdr
only.
"""
import json

import numpy as np
import pytest
import torch

from gshell_tpu.data.datasets import DatasetLLFF as JDatasetLLFF
from gshell_tpu.data.datasets import DatasetNeRFColmap as JDatasetNeRFColmap
from gshell_tpu.data.datasets import _lines_focal as j_lines_focal
from gshell_tpu_torch.data.datasets import DatasetLLFF, DatasetNeRFColmap, _lines_focal
from gshell_tpu_torch.utils.image import save_image
from torch_parity import assert_close, n

H, W, N = 24, 32, 4


def _frames(rng):
    """N RGB frames and N RGB masks (a disc each) in [0, 1]."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = []
    for i in range(N):
        img = rng.uniform(size=(H, W, 3))
        disc = ((xs - W / 2 - i) ** 2 + (ys - H / 2) ** 2 < (0.3 * H) ** 2).astype(np.float64)
        out.append((img, np.repeat(disc[..., None], 3, axis=-1)))
    return out


def _pose(rng, i):
    """A camera-to-world matrix looking at the origin from radius 3."""
    ang = 2 * np.pi * i / N + 0.1
    eye = np.array([3 * np.sin(ang), 0.5 + 0.1 * i, 3 * np.cos(ang)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, -fwd, eye
    return m + rng.normal(0.0, 1e-3, (4, 4)) * np.r_[np.ones(3), 0][:, None]


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("colmap")
    (d / "image").mkdir()
    (d / "mask").mkdir()
    rng = np.random.default_rng(0)
    frames = []
    for i, (img, mask) in enumerate(_frames(rng)):
        save_image(str(d / "image" / f"{i:03d}.png"), img)
        if i != 2:  # a frame without a mask keeps alpha 1
            save_image(str(d / "mask" / f"{i:03d}.png"), mask)
        frames.append({"file_path": f"image/{i:03d}.png", "camera_angle_x": 0.6 + 0.05 * i,
                       "transform_matrix": _pose(rng, i).tolist()})
    (d / "transforms.json").write_text(json.dumps({"frames": frames}))
    return d


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    (d / "images").mkdir()
    (d / "masks").mkdir()
    rng = np.random.default_rng(1)
    rows = []
    for i, (img, mask) in enumerate(_frames(rng)):
        save_image(str(d / "images" / f"img_{i:02d}.png"), img)
        if i < N - 1:  # the last frame has no mask
            save_image(str(d / "masks" / f"img_{i:02d}.png"), mask)
        c2w = _pose(rng, i)[:3]
        # LLFF stores [down, right, back] columns: the inverse of the loader's swizzle
        llff = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3]], axis=1)
        hwf = np.array([H, W, 40.0 + 3 * i])[:, None]
        rows.append(np.concatenate([np.concatenate([llff, hwf], axis=1).reshape(-1), [0.5, 10.0]]))
    np.save(str(d / "poses_bounds.npy"), np.stack(rows))
    return d


def _hold(port, jax_ds):
    assert len(port) == jax_ds.mvp.shape[0] == N
    assert_close(port.mvp, jax_ds.mvp, rtol=1e-6, atol=1e-6, what="mvp")
    assert_close(port.campos, jax_ds.campos, rtol=1e-6, atol=1e-6, what="campos")
    np.testing.assert_array_equal(n(port.imgs), jax_ds.imgs)
    alpha = n(port.imgs)[..., 3]
    assert 0 < alpha.mean() < 1 and set(np.unique(alpha)) <= {0.0, 1.0}


def test_colmap_matches_jax(colmap_dir):
    cfg = str(colmap_dir / "transforms.json")
    _hold(DatasetNeRFColmap(cfg, train_res=(H, W)), JDatasetNeRFColmap(cfg, train_res=(H, W)))
    assert (n(DatasetNeRFColmap(cfg, train_res=(H, W)).imgs)[2, ..., 3] == 1).all()


def test_llff_matches_jax(llff_dir):
    _hold(DatasetLLFF(str(llff_dir), train_res=(H, W)), JDatasetLLFF(str(llff_dir), train_res=(H, W)))


def test_lines_focal_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(6, 3)).astype(np.float32)
    d = (-o + rng.normal(0.0, 0.05, (6, 3))).astype(np.float32)
    np.testing.assert_allclose(_lines_focal(o, d), j_lines_focal(o, d), rtol=1e-12, atol=1e-12)
    assert np.linalg.norm(_lines_focal(o, d)) < 0.2  # the rays point near the origin


def test_port_loaders_resize_to_the_training_resolution(colmap_dir, llff_dir):
    for ds in (DatasetNeRFColmap(str(colmap_dir / "transforms.json"), train_res=(12, 16)),
               DatasetLLFF(str(llff_dir), train_res=(12, 16))):
        assert tuple(ds.imgs.shape) == (N, 12, 16, 4) and ds.resolution == (12, 16)
        assert torch.isfinite(ds.imgs).all() and ds.batch(np.array([0, 1]))["img"].shape == (2, 12, 16, 4)


def test_a_jpeg_frame_raises_and_names_the_format(tmp_path):
    (tmp_path / "image").mkdir()
    (tmp_path / "image" / "000.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(64))
    (tmp_path / "transforms.json").write_text(json.dumps({"frames": [
        {"file_path": "image/000.jpg", "camera_angle_x": 0.6, "transform_matrix": np.eye(4).tolist()}]}))
    with pytest.raises(ValueError, match="not a PNG file"):
        DatasetNeRFColmap(str(tmp_path / "transforms.json"), train_res=(H, W))
