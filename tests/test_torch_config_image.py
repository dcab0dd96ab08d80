"""The port's config loader and image IO against the JAX package's.

``gshell_tpu_torch/utils/config.py`` is a copy: every ``configs/*.json``
loads to equal ``Flags`` and learning rates.  ``gshell_tpu_torch/utils/image.py``
reads and writes PNG with numpy and ``zlib`` only: its PNGs read back equal
through ``imageio``, ``imageio``'s PNGs (and PNGs using each of the five row
filters) decode equal in the port, and ``.hdr`` bytes equal the JAX package's.
"""
import dataclasses
import glob
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from gshell_tpu.utils import config as jconfig
from gshell_tpu.utils import image as jimage
from gshell_tpu_torch.utils import config as tconfig
from gshell_tpu_torch.utils import image as timage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_equal_flags(path):
    a, b = tconfig.load_flags(path), jconfig.load_flags(path)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tconfig.learning_rates(a) == jconfig.learning_rates(b)


def test_config_defaults_overrides_and_errors_equal():
    assert [f.name for f in dataclasses.fields(tconfig.Flags)] == \
        [f.name for f in dataclasses.fields(jconfig.Flags)]
    assert dataclasses.asdict(tconfig.Flags()) == dataclasses.asdict(jconfig.Flags())
    kw = dict(iter=7, batch=None, n_samples=3, out_dir="x")
    assert dataclasses.asdict(tconfig.load_flags(CONFIGS[0], **kw)) == \
        dataclasses.asdict(jconfig.load_flags(CONFIGS[0], **kw))
    for lr in (0.02, [0.03], [0.03, 0.005], [0.03, 0.005, 0.1]):
        assert tconfig.learning_rates(tconfig.Flags(learning_rate=lr)) == \
            jconfig.learning_rates(jconfig.Flags(learning_rate=lr))
    for bad in (dict(spp=0), dict(n_samples=0)):
        with pytest.raises(ValueError):
            tconfig.load_flags(None, **bad)
        with pytest.raises(ValueError):
            jconfig.load_flags(None, **bad)


def _random_u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 2), (9, 31, 3), (16, 8, 4)])
def test_port_png_reads_back_through_imageio(tmp_path, shape):
    arr = _random_u8(shape)
    path = str(tmp_path / "a.png")
    timage.save_png(path, arr)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), arr)


@pytest.mark.parametrize("shape", [(13, 17), (9, 31, 3), (16, 8, 4)])
def test_imageio_png_decodes_equal_in_the_port(tmp_path, shape):
    arr = _random_u8(shape, seed=1)
    # a smooth ramp too, which the encoder compresses with its row filters
    ramp = (np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1])) % 256).astype(np.uint8)
    smooth = ramp if len(shape) == 2 else np.stack([ramp + 40 * c for c in range(shape[2])], -1)
    for img in (arr, smooth):
        path = str(tmp_path / "b.png")
        imageio.imwrite(path, img)
        np.testing.assert_array_equal(timage.load_png(path), np.asarray(imageio.imread(path)))
        np.testing.assert_array_equal(timage.load_image(path), jimage.load_image(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray) -> bytes:
    """An RGB PNG whose row y uses filter type y % 5 (None, Sub, Up,
    Average, Paeth), encoded by the PNG specification's definitions."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        ftype = y % 5
        out.append(ftype)
        for i in range(w * c):
            x = rows[y, i]
            a = rows[y, i - c] if i >= c else 0
            b = rows[y - 1, i] if y > 0 else 0
            cc = rows[y - 1, i - c] if y > 0 and i >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[ftype]
            out.append((x - pred) % 256)
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def test_every_png_row_filter_decodes(tmp_path):
    img = _random_u8((11, 7, 3), seed=2)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img))
    np.testing.assert_array_equal(timage.load_png(str(path)), img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(str(path))), img)


def test_unsupported_png_raises(tmp_path):
    path = tmp_path / "deep.png"
    imageio.imwrite(str(path), np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    with pytest.raises(ValueError, match="bit depth 16"):
        timage.load_png(str(path))
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(ValueError, match="not a PNG"):
        timage.load_image(str(tmp_path / "x.jpg"))


def test_save_image_png_equals_the_jax_package(tmp_path):
    img = np.random.default_rng(3).uniform(-0.2, 1.2, size=(10, 12, 3)).astype(np.float32)
    timage.save_image(str(tmp_path / "t.png"), img)
    jimage.save_image(str(tmp_path / "j.png"), img)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "t.png")), imageio.imread(str(tmp_path / "j.png")))


def test_hdr_bytes_equal_the_jax_package(tmp_path):
    img = np.random.default_rng(4).lognormal(size=(9, 14, 3)).astype(np.float32)
    img[0, 0] = 0.0
    timage.save_image(str(tmp_path / "t.hdr"), img)
    jimage.save_image(str(tmp_path / "j.hdr"), img)
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    np.testing.assert_array_equal(timage.load_hdr(str(tmp_path / "t.hdr")),
                                  jimage.load_hdr(str(tmp_path / "j.hdr")))
