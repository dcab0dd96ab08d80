"""The port's validation against the JAX package's: ``validate`` on the same
views and the same rendered buffers (``metrics.txt`` and the averages to
rtol 1e-6, the triptychs equal), ``chamfer_distance`` with the JAX surface
samples replayed (rtol 1e-5), and the small math it uses."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gshell_tpu.data.datasets import PosedImageDataset as JPosed
from gshell_tpu.ops import math as jm
from gshell_tpu.train.validate import chamfer_distance as j_chamfer
from gshell_tpu.train.validate import validate as j_validate
from gshell_tpu_torch.data.datasets import PosedImageDataset as TPosed
from gshell_tpu_torch.ops import math as tm
from gshell_tpu_torch.train.validate import chamfer_distance, validate
from gshell_tpu_torch.utils.image import load_png
from gshell_tpu_torch.utils.rng import ReplayDraws
from gshell_tpu_torch.utils.synthetic_gt import skirt, sphere
from torch_parity import _draw, assert_close, n

H, W, N_VIEWS = 12, 10, 3


def _views():
    rng = np.random.default_rng(0)
    imgs = rng.random((N_VIEWS, H, W, 4), dtype=np.float32)
    imgs[..., 3] = (imgs[..., 3] > 0.3).astype(np.float32)
    imgs[..., :3] *= imgs[..., 3:]
    shaded = np.clip(imgs + rng.normal(scale=0.05, size=imgs.shape).astype(np.float32), 0, 1.3)
    campos = np.zeros((N_VIEWS, 3), np.float32)
    campos[:, 0] = np.arange(N_VIEWS)  # names the view for the render function
    return imgs, shaded, campos, np.tile(np.eye(4, dtype=np.float32), (N_VIEWS, 1, 1))


def test_validate_matches_jax(tmp_path):
    imgs, shaded, campos, mvp = _views()
    ds_j, ds_t = JPosed(), TPosed()
    ds_j.imgs, ds_j.campos, ds_j.mvp = imgs, campos, mvp
    ds_t.imgs, ds_t.campos, ds_t.mvp = (torch.as_tensor(a) for a in (imgs, campos, mvp))
    render_j = lambda b: {"shaded": jnp.asarray(shaded[int(b["campos"][0, 0])])[None]}
    render_t = lambda b: {"shaded": torch.as_tensor(shaded[int(b["campos"][0, 0])])[None]}
    mj = j_validate(render_j, ds_j, out_dir=str(tmp_path / "j"), dump_images=True)
    mt = validate(render_t, ds_t, out_dir=str(tmp_path / "t"), dump_images=True)
    assert_close(mt["mse"], mj["mse"], rtol=1e-6, what="mse")
    assert_close(mt["psnr"], mj["psnr"], rtol=1e-6, what="psnr")
    assert_close(np.array(mt["per_view"]), np.array(mj["per_view"]), rtol=1e-6, what="per view")
    lines_t = (tmp_path / "t" / "metrics.txt").read_text().splitlines()
    lines_j = (tmp_path / "j" / "metrics.txt").read_text().splitlines()
    assert lines_t[0] == lines_j[0] == "ID, MSE, PSNR" and len(lines_t) == len(lines_j) == N_VIEWS + 2
    for a, b in zip(lines_t[1:], lines_j[1:]):
        va = [float(x) for x in a.replace("AVERAGES:", "").split(",")]
        vb = [float(x) for x in b.replace("AVERAGES:", "").split(",")]
        assert_close(np.array(va), np.array(vb), rtol=1e-3, atol=1e-4, what=a)  # printed to 3-8 digits
    for i in range(N_VIEWS):
        ta, ja = load_png(str(tmp_path / "t" / f"val_{i:03d}.png")), load_png(str(tmp_path / "j" / f"val_{i:03d}.png"))
        assert ta.shape == (H, 3 * W, 3) and int(np.abs(ta.astype(int) - ja.astype(int)).max()) <= 1


def _chamfer_source(key):
    k1, k2 = jax.random.split(key)

    def source(kind, name, shape, lo, hi):
        which, _, rest = name.partition("/")
        k_face, k_uv = jax.random.split(k1 if which == "a" else k2)
        return _draw(kind, k_face if rest == "face" else k_uv, shape, lo, hi)
    return source


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_matches_jax(masked):
    va, fa = sphere(24, 16)
    vb, fb = skirt(24, 12)
    vb = vb * 0.8
    mask = (np.arange(len(fa)) % 3 != 0) if masked else None
    key = jax.random.PRNGKey(1)
    want = j_chamfer(key, jnp.asarray(va), jnp.asarray(fa), jnp.asarray(vb), jnp.asarray(fb),
                     n_samples=3000, mask1=None if mask is None else jnp.asarray(mask), chunk=512)
    got = chamfer_distance(ReplayDraws(_chamfer_source(key)), torch.as_tensor(va), torch.as_tensor(fa).long(),
                           torch.as_tensor(vb), torch.as_tensor(fb).long(), n_samples=3000,
                           mask1=None if mask is None else torch.as_tensor(mask), chunk=512)
    assert float(got) > 0
    assert_close(got, want, rtol=1e-5, what="chamfer")


def test_chamfer_is_zero_on_the_same_samples():
    v, f = sphere(16, 12)
    same = lambda kind, name, shape, lo, hi: np.random.default_rng(len(name.split("/")[1])).uniform(
        lo, hi, size=shape).astype(np.float32)
    cd = chamfer_distance(ReplayDraws(same), torch.as_tensor(v), torch.as_tensor(f).long(),
                          torch.as_tensor(v), torch.as_tensor(f).long(), n_samples=1024, chunk=256)
    assert float(cd) == 0.0


def test_mse_to_psnr_and_rotate_x_match_jax():
    mse = np.array([0.0, 1e-12, 1e-4, 0.02, 1.0], np.float32)
    assert_close(tm.mse_to_psnr(torch.as_tensor(mse)), jm.mse_to_psnr(jnp.asarray(mse)), rtol=1e-6,
                 what="psnr")
    for a in (0.0, -math.pi / 2, 0.7):
        np.testing.assert_array_equal(n(tm.rotate_x(a)), np.asarray(jm.rotate_x(a)))
