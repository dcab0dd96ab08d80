"""Image IO (twin of ``gshell_tpu/utils/image.py``) with no imaging library.

PNG is written and read with numpy and the standard library's ``zlib``: 8-bit,
non-interlaced grey, grey + alpha, RGB and RGBA.  Any other PNG (16-bit,
palette, interlaced) and any other format raises ``ValueError`` naming what
it found.  ``.hdr`` is Radiance RGBE, as in the JAX package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type → channels
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def save_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, C) array, C in 1..4, as PNG."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"save_png: needs uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"save_png: {c} channels (1 to 4 are supported)")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def load_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG → uint8 (H, W) for grey, else
    (H, W, C), as ``imageio`` returns it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file (only PNG and .hdr images are supported)")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}); only 8-bit non-interlaced grey, grey+alpha, "
                         "RGB and RGBA are read")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data size {raw.size} != {h} x {stride + 1}")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            rec = cur.copy()
        elif ftype == 1:  # sub: running sum per channel, mod 256
            rec = np.cumsum(cur.reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            rec = cur + prev
        elif ftype in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prev.tobytes(), c)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has filter type {ftype}")
        out[y] = rec
        prev = out[y]
    img = out.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def save_image(path: str, img) -> None:
    """Save a float image in [0, 1] (H, W, 3|4) as PNG (sRGB'd by the
    caller); ``.hdr`` paths write linear Radiance RGBE instead."""
    if path.lower().endswith(".hdr"):
        return save_hdr(path, np.asarray(img)[..., :3])
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only .png and .hdr images are written")
    arr = np.clip(np.asarray(img), 0.0, 1.0)
    save_png(path, (arr * 255).astype(np.uint8))


def save_hdr(path: str, img: np.ndarray) -> None:
    """Minimal Radiance RGBE (.hdr) writer (flat, uncompressed scanlines)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    valid = maxc > 1e-32
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float64)
    m, e = np.frexp(maxc[valid].astype(np.float64))
    mant[valid] = m
    exp[valid] = e
    scale = np.where(valid, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) reader: flat and (new-style) RLE scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; next line is the resolution
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])
    buf = data[eol + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    off = 0
    if not (8 <= w < 32768 and len(buf) >= 4 and buf[0] == 2 and buf[1] == 2):
        rgbe = np.frombuffer(buf[: h * w * 4], np.uint8).reshape(h, w, 4).copy()
    else:
        for y in range(h):
            if buf[off] != 2 or buf[off + 1] != 2:
                raise ValueError(f"{path}: bad RLE scanline {y}")
            off += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = buf[off]
                    off += 1
                    if n > 128:  # run
                        rgbe[y, x : x + n - 128, c] = buf[off]
                        off += 1
                        x += n - 128
                    else:  # literal
                        rgbe[y, x : x + n, c] = np.frombuffer(buf[off : off + n], np.uint8)
                        off += n
                        x += n
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None].astype(np.float32)


def load_image(path: str) -> np.ndarray:
    """float32 image: ``.hdr`` as stored, PNG scaled to [0, 1]."""
    if path.lower().endswith(".hdr"):
        return load_hdr(path)
    return load_png(path).astype(np.float32) / 255.0
