"""ctypes bindings for the native C++ host runtime (libwass_native.so).

Builds on first use (g++ via the bundled Makefile) and degrades
gracefully: `available()` is False when the toolchain or image libraries
are missing, and callers fall back to the pure-Python IO paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).parent
_LIB_PATH = _DIR / "libwass_native.so"
_lib = None
_build_lock = threading.Lock()


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-s", "libwass_native.so"],
            cwd=_DIR,
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        src = _DIR / "wass_native.cpp"
        stale = _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime < src.stat().st_mtime
        if not _LIB_PATH.exists() or stale:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        c = ctypes
        lib.wass_png_read_gray.argtypes = [c.c_char_p, c.c_void_p, c.POINTER(c.c_int), c.POINTER(c.c_int)]
        lib.wass_png_write_gray.argtypes = [c.c_char_p, c.c_void_p, c.c_int, c.c_int]
        lib.wass_jpeg_encode.argtypes = [
            c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
            c.POINTER(c.c_void_p), c.POINTER(c.c_ulong),
        ]
        lib.wass_free.argtypes = [c.c_void_p]
        lib.wass_xyzc_write.argtypes = [
            c.c_char_p, c.c_void_p, c.c_void_p, c.c_int64,
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int,
        ]
        lib.wass_xyzc_read.argtypes = [c.c_char_p, c.c_void_p, c.POINTER(c.c_int64)]
        lib.wass_prefetcher_create.restype = c.c_void_p
        lib.wass_prefetcher_create.argtypes = [c.c_int]
        lib.wass_prefetcher_destroy.argtypes = [c.c_void_p]
        lib.wass_prefetcher_submit.restype = c.c_int64
        lib.wass_prefetcher_submit.argtypes = [c.c_void_p, c.c_char_p]
        lib.wass_prefetcher_dims.argtypes = [c.c_void_p, c.c_int64, c.POINTER(c.c_int), c.POINTER(c.c_int)]
        lib.wass_prefetcher_take.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------


def png_read_gray(path) -> np.ndarray:
    lib = load()
    assert lib is not None
    w = ctypes.c_int()
    h = ctypes.c_int()
    st = lib.wass_png_read_gray(str(path).encode(), None, ctypes.byref(w), ctypes.byref(h))
    if st != 0:
        raise IOError(f"PNG read failed ({st}): {path}")
    buf = np.empty((h.value, w.value), np.uint8)
    st = lib.wass_png_read_gray(str(path).encode(), buf.ctypes.data_as(ctypes.c_void_p), ctypes.byref(w), ctypes.byref(h))
    if st != 0:
        raise IOError(f"PNG read failed ({st}): {path}")
    return buf


def png_write_gray(path, img: np.ndarray) -> None:
    lib = load()
    assert lib is not None
    img = np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8))
    st = lib.wass_png_write_gray(str(path).encode(), img.ctypes.data_as(ctypes.c_void_p), img.shape[1], img.shape[0])
    if st != 0:
        raise IOError(f"PNG write failed ({st}): {path}")


def jpeg_encode(img: np.ndarray, quality: int = 90) -> bytes:
    """JPEG bytes of an (H, W) grayscale or (H, W, 3) RGB image."""
    lib = load()
    assert lib is not None
    img = np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8))
    if img.ndim == 3 and img.shape[2] != 3:
        raise ValueError(f"JPEG needs 1 or 3 channels, got {img.shape[2]}")
    out = ctypes.c_void_p()
    size = ctypes.c_ulong()
    lib.wass_jpeg_encode(
        img.ctypes.data_as(ctypes.c_void_p), img.shape[1], img.shape[0],
        1 if img.ndim == 2 else 3, quality,
        ctypes.byref(out), ctypes.byref(size),
    )
    data = ctypes.string_at(out, size.value)
    lib.wass_free(out)
    return data


def xyzc_write(path, pts: np.ndarray, mask: np.ndarray, Rpl, Tpl, Rinv, Tinv, n_threads: int = 0) -> None:
    """Fused compact+transform+quantize .xyzC writer.

    pts: (N, 3) float32 camera-frame points; mask: (N,) bool/uint8.
    Rpl/Tpl: cam->plane transform applied before quantization;
    Rinv/Tinv: stored inverse transform (plane->cam).
    """
    lib = load()
    assert lib is not None
    pts = np.ascontiguousarray(pts.reshape(-1, 3), np.float32)
    mask = np.ascontiguousarray(mask.reshape(-1), np.uint8)
    Rpl = np.ascontiguousarray(Rpl, np.float64)
    Tpl = np.ascontiguousarray(np.asarray(Tpl).reshape(3), np.float64)
    Rinv = np.ascontiguousarray(Rinv, np.float64)
    Tinv = np.ascontiguousarray(np.asarray(Tinv).reshape(3), np.float64)
    st = lib.wass_xyzc_write(
        str(path).encode(),
        pts.ctypes.data_as(ctypes.c_void_p),
        mask.ctypes.data_as(ctypes.c_void_p),
        pts.shape[0],
        Rpl.ctypes.data_as(ctypes.c_void_p),
        Tpl.ctypes.data_as(ctypes.c_void_p),
        Rinv.ctypes.data_as(ctypes.c_void_p),
        Tinv.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if st != 0:
        raise IOError(f"xyzC write failed ({st}): {path}")


def xyzc_read(path) -> np.ndarray:
    """Decode .xyzC to (3, N) camera-frame doubles (wass_utils contract)."""
    lib = load()
    assert lib is not None
    n = ctypes.c_int64()
    st = lib.wass_xyzc_read(str(path).encode(), None, ctypes.byref(n))
    if st != 0:
        raise IOError(f"xyzC read failed ({st}): {path}")
    buf = np.empty((n.value, 3), np.float64)
    st = lib.wass_xyzc_read(str(path).encode(), buf.ctypes.data_as(ctypes.c_void_p), ctypes.byref(n))
    if st != 0:
        raise IOError(f"xyzC read failed ({st}): {path}")
    return buf.T


class Prefetcher:
    """Threaded PNG prefetcher: submit paths ahead, take decoded frames."""

    def __init__(self, n_threads: int = 4):
        lib = load()
        assert lib is not None
        self._lib = lib
        self._p = lib.wass_prefetcher_create(n_threads)

    def submit(self, path) -> int:
        return self._lib.wass_prefetcher_submit(self._p, str(path).encode())

    def take(self, ticket: int) -> np.ndarray:
        w = ctypes.c_int()
        h = ctypes.c_int()
        st = self._lib.wass_prefetcher_dims(self._p, ticket, ctypes.byref(w), ctypes.byref(h))
        if st != 0:
            raise IOError(f"prefetch failed ({st})")
        buf = np.empty((h.value, w.value), np.uint8)
        st = self._lib.wass_prefetcher_take(self._p, ticket, buf.ctypes.data_as(ctypes.c_void_p))
        if st != 0:
            raise IOError(f"prefetch take failed ({st})")
        return buf

    def close(self):
        if self._p:
            self._lib.wass_prefetcher_destroy(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
