"""8-bit PNG read/write for the frame pipeline.

PNG IO goes through the native library (wass_tpu/native, libpng) when it
builds; otherwise through the small numpy + zlib codec below, which reads
and writes non-interlaced 8-bit PNGs (grayscale, gray+alpha, RGB, RGBA;
all five row filters).  Other image formats (JPEG, TIFF, ...) need
imageio, which the frame pipeline itself never imports.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_gray(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an (H, W) uint8 image (filter 0 on every row)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape
    raw = np.zeros((H, W + 1), np.uint8)
    raw[:, 1:] = img
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return (
        _SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def _unfilter(data: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((H, stride), np.uint8)
    rows = data.reshape(H, stride + 1)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
            cur = (cur % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int64)
            ln, up = line.astype(np.int64), prev.astype(np.int64)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (ln[i] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode(data: bytes) -> np.ndarray:
    """Decode 8-bit PNG bytes to (H, W) or (H, W, C) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    W, H, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, interlace {interlace})"
        )
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, H, W * C, C).reshape(H, W, C)
    return img[..., 0] if C == 1 else img


def _is_png(path) -> bool:
    return str(path).lower().endswith(".png")


def write_gray(path, img: np.ndarray) -> None:
    """Write an (H, W) image as 8-bit grayscale PNG (clipped to [0, 255])."""
    from wass_tpu import native

    img8 = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    if native.available():
        native.png_write_gray(path, img8)
    else:
        Path(path).write_bytes(encode_gray(img8))


def read_gray(path) -> np.ndarray:
    """Read an image as (H, W) grayscale: uint8 for PNG (colour averaged
    to float32 when the file has several channels)."""
    from wass_tpu import native

    if _is_png(path):
        if native.available():
            return native.png_read_gray(path)
        img = decode(Path(path).read_bytes())
    else:
        import imageio.v3 as iio

        img = iio.imread(path)
    if img.ndim == 3:
        img = img[..., :3].mean(axis=-1, dtype=np.float32)
    return img
