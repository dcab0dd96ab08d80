"""The port's posed-image datasets against the JAX package's, on fake files
built as ``tests/test_datasets.py`` builds them.

``load_K_Rt_from_P`` to 1e-5; the DeepFashion (with and without a mask
directory) and NeRF loaders at a downscale and an upscale: ``mvp`` /
``campos`` to 1e-5 and images to 1e-5 after the resize (``jax.image.resize``
antialiases when it shrinks, and so does the port); ``iterate(seed)`` view
indices and random backgrounds bit for bit.

The JAX loaders premultiply the resized image in place, and
``np.asarray`` of ``jax.image.resize``'s result is read-only, so at any
resolution other than the files' they raise.  The tests give them a writable
copy of the same resize (``writable_jax_resize``); the port's loaders resize
into a fresh array."""
import json

import imageio.v2 as imageio
import numpy as np
import pytest

from gshell_tpu.data import datasets as jds
from gshell_tpu_torch.data import datasets as tds
from torch_parity import assert_close, n

RES = {"down": (24, 20), "up": (48, 40)}  # from 32² / 36×28 sources


def _write_png(path, shape, seed):
    imageio.imwrite(str(path), np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8))


@pytest.fixture
def writable_jax_resize(monkeypatch):
    resize = jds._resize_np
    monkeypatch.setattr(jds, "_resize_np", lambda img, res: np.array(resize(img, res)))


@pytest.fixture
def fake_deepfashion(tmp_path):
    n_img = 3
    cams = {}
    K = np.array([[400.0, 0, 16], [0, 400, 16], [0, 0, 1]])
    (tmp_path / "masks").mkdir()
    for i in range(n_img):
        th = i * 0.5
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
        C = -R.T @ np.array([0, 0, 3.0])
        P = K @ np.concatenate([R, (-R @ C)[:, None]], 1)
        world = np.eye(4, dtype=np.float32)
        world[:3, :4] = P
        cams[f"world_mat_{i}"] = world
        cams[f"scale_mat_{i}"] = np.diag([1.1, 1.1, 1.1, 1.0]).astype(np.float32)
        _write_png(tmp_path / f"{i:03d}.png", (32, 32, 4), i)
        _write_png(tmp_path / "masks" / f"{i:03d}.png", (32, 32, 3), 10 + i)
    np.savez(str(tmp_path / "cameras_sphere.npz"), **cams)
    return str(tmp_path), n_img


def _check_views(t, j):
    assert len(t) == len(j)
    assert_close(t.mvp, j.mvp, rtol=1e-5, atol=1e-5, what="mvp")
    assert_close(t.campos, j.campos, rtol=1e-5, atol=1e-5, what="campos")
    assert_close(t.imgs, j.imgs, rtol=1e-5, atol=1e-5, what="imgs")


def test_load_K_Rt_from_P_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        P = rng.normal(size=(3, 4))
        for a, b in zip(tds.load_K_Rt_from_P(P), jds.load_K_Rt_from_P(P)):
            assert_close(a, b, rtol=1e-5, atol=1e-5, what="K / pose")


@pytest.mark.parametrize("scale", ["down", "up"])
def test_deepfashion_loader_matches_jax(fake_deepfashion, writable_jax_resize, scale):
    path, n_img = fake_deepfashion
    _check_views(tds.DatasetDeepFashion(path, train_res=RES[scale], n_images=n_img),
                 jds.DatasetDeepFashion(path, train_res=RES[scale], n_images=n_img))


@pytest.mark.parametrize("scale", ["down", "up"])
def test_deepfashion_testset_matches_jax(fake_deepfashion, writable_jax_resize, scale):
    path, n_img = fake_deepfashion
    masks = f"{path}/masks"
    _check_views(tds.DatasetDeepFashionTestset(path, masks, train_res=RES[scale], n_images=n_img),
                 jds.DatasetDeepFashionTestset(path, masks, train_res=RES[scale], n_images=n_img))


@pytest.mark.parametrize("scale", ["down", "up"])
def test_nerf_loader_matches_jax(tmp_path, writable_jax_resize, scale):
    frames = []
    for i in range(2):
        _write_png(tmp_path / f"r_{i}.png", (36, 28, 4), 20 + i)
        xf = np.eye(4)
        xf[:3, 3] = [0.3 * i, -0.2, 4.0]
        frames.append({"file_path": f"r_{i}", "transform_matrix": xf.tolist()})
    cfg = tmp_path / "transforms_train.json"
    cfg.write_text(json.dumps({"camera_angle_x": 0.7, "frames": frames}))
    _check_views(tds.DatasetNeRF(str(cfg), train_res=RES[scale]), jds.DatasetNeRF(str(cfg), train_res=RES[scale]))


@pytest.mark.parametrize("background", ["random", "white", "black"])
def test_iterate_matches_jax_bit_for_bit(fake_deepfashion, writable_jax_resize, background):
    path, n_img = fake_deepfashion
    t = tds.DatasetDeepFashion(path, train_res=(16, 16), n_images=n_img)
    j = jds.DatasetDeepFashion(path, train_res=(16, 16), n_images=n_img)
    j.imgs = n(t.imgs)  # the same stored views, so the batches must agree exactly
    j.mvp, j.campos = n(t.mvp), n(t.campos)
    for seed in (0, 5):
        for bt, bj in zip(t.iterate(2, 4, background, seed), j.iterate(2, 4, background, seed)):
            for k in ("mvp", "campos", "img", "background"):
                np.testing.assert_array_equal(n(bt[k]), np.asarray(bj[k]), err_msg=k)
    # a restored stream continues where a run stopped
    rng = np.random.default_rng(3)
    first = [n(b["img"]) for b in t.iterate(1, 3, background, rng=rng)]
    state = np.random.default_rng(3)
    list(t.iterate(1, 1, background, rng=state))
    rest = [n(b["img"]) for b in t.iterate(1, 2, background, rng=state)]
    for a, b in zip(first[1:], rest):
        np.testing.assert_array_equal(a, b)


def test_resize_matches_jax_down_and_up():
    import jax
    import jax.numpy as jnp

    img = np.random.default_rng(1).random((40, 56, 4), dtype=np.float32)
    for res in ((24, 20), (64, 80), (40, 30)):
        want = np.asarray(jax.image.resize(jnp.asarray(img), res + (4,), "linear"))
        assert_close(tds.resize_image(img, res), want, rtol=1e-5, atol=1e-6, what=str(res))
