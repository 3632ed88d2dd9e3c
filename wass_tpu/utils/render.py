"""Debug-image rendering (render.hpp + the matcher/stereo debug imagery).

Host-side numpy equivalents of the reference's diagnostic outputs:
normalized disparity PNGs (render_disparity_float, render.hpp:55-87),
side-by-side / stacked stereo composites with scanlines (:89-173),
match visualizations (wass_match.cpp:70-95), and disparity-coverage
overlays (wass_stereo.cpp:1006-1025).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _save(path, img):
    """JPEG through the native library when it builds, PNG through the
    numpy codec for grayscale .png, anything else through imageio."""
    from wass_tpu import native

    img8 = np.clip(img, 0, 255).astype(np.uint8)
    suffix = Path(path).suffix.lower()
    if suffix in (".jpg", ".jpeg") and native.available():
        Path(path).write_bytes(native.jpeg_encode(img8))
        return
    if suffix == ".png" and img8.ndim == 2:
        from wass_tpu.io.png import write_gray

        write_gray(path, img8)
        return
    import imageio.v3 as iio

    iio.imwrite(Path(path), img8)


def render_disparity(path, disp: np.ndarray) -> None:
    """Normalized disparity visualization; invalid (0) stays black."""
    d = np.asarray(disp, np.float64)
    m = d > 0
    if m.any():
        lo, hi = d[m].min(), d[m].max()
        vis = np.where(m, (d - lo) / max(hi - lo, 1e-9) * 235 + 20, 0)
    else:
        vis = np.zeros_like(d)
    _save(path, vis)


def render_stereo(path, left: np.ndarray, right: np.ndarray, vertical: bool = False, n_lines: int = 20) -> None:
    """Stereo composite with epipolar scanlines for rectification checks
    (the stereo.jpg output, wass_stereo.cpp:1910-1926)."""
    L = np.asarray(left, np.float64)
    R = np.asarray(right, np.float64)
    comp = np.concatenate([L, R], axis=0 if vertical else 1)
    comp = np.stack([comp] * 3, axis=-1)
    H = comp.shape[0]
    steps = max(H // (n_lines + 1), 1)
    for y in range(steps, H, steps):
        comp[y, :, 0] = 255
        comp[y, :, 1:] *= 0.4
    _save(path, comp)


def render_matches(path, img0: np.ndarray, img1: np.ndarray, uv0: np.ndarray, uv1: np.ndarray) -> None:
    """Side-by-side match plot (render_matches, wass_match.cpp:70-95),
    drawn with cheap numpy line rasterization."""
    L = np.asarray(img0, np.float64)
    R = np.asarray(img1, np.float64)
    comp = np.concatenate([L, R], axis=1)
    comp = np.stack([comp] * 3, axis=-1)
    W0 = L.shape[1]
    for (x0, y0), (x1, y1) in zip(np.asarray(uv0), np.asarray(uv1)):
        x1s = x1 + W0
        n = int(max(abs(x1s - x0), abs(y1 - y0), 1))
        xs = np.linspace(x0, x1s, n).astype(int)
        ys = np.linspace(y0, y1, n).astype(int)
        ok = (xs >= 0) & (xs < comp.shape[1]) & (ys >= 0) & (ys < comp.shape[0])
        comp[ys[ok], xs[ok]] = [255, 255, 0]
    _save(path, comp)


def render_coverage(path, img: np.ndarray, disp: np.ndarray, roi=None) -> None:
    """Green-tint disparity coverage over the rectified base image
    (disparity_coverage.jpg, wass_stereo.cpp:1006-1025)."""
    I = np.asarray(img, np.float64)
    vis = np.stack([I] * 3, axis=-1)
    covered = np.asarray(disp) > 1
    vis[..., 1] = np.where(covered, np.maximum(vis[..., 1], 100), vis[..., 1])
    if roi is not None:
        x, y, w, h = roi
        vis[y : y + h, [x, min(x + w - 1, vis.shape[1] - 1)], 0] = 255
        vis[[y, min(y + h - 1, vis.shape[0] - 1)], x : x + w, 0] = 255
    _save(path, vis)


def render_failure_map(path, reasons: np.ndarray, base_gray: Optional[np.ndarray] = None) -> None:
    """Color-coded triangulation failure map (the reference's dbg_R0/R1
    imagery, wass_stereo.cpp:1114-1119,1378-1383), same RGB code:
    triangulated pixels show the grayscale image (or mid-gray), failures
    show teal (outside image), yellow (bbox/roi/burned), green (angle
    gate), blue (too close), red (too distant), black (no disparity)."""
    from wass_tpu.stereo.dense import (
        FAIL_ANGLE, FAIL_BURNED, FAIL_NO_DISPARITY, FAIL_OK,
        FAIL_OUTSIDE_BBOX, FAIL_OUTSIDE_IMAGE, FAIL_TOO_CLOSE,
        FAIL_TOO_DISTANT,
    )

    r = np.asarray(reasons)
    H, W = r.shape
    if base_gray is not None:
        g = np.clip(np.asarray(base_gray, np.float64), 0, 255)
        img = np.stack([g] * 3, axis=-1)
    else:
        img = np.full((H, W, 3), 128.0)
    # Reference colors are BGR cv::Vec3b; stored here as RGB.
    colors = {
        FAIL_NO_DISPARITY: (0, 0, 0),
        FAIL_OUTSIDE_IMAGE: (0, 255, 255),   # teal
        FAIL_OUTSIDE_BBOX: (255, 255, 0),    # yellow
        FAIL_BURNED: (255, 255, 0),          # mask color
        FAIL_ANGLE: (0, 255, 0),             # green
        FAIL_TOO_CLOSE: (0, 0, 255),         # blue
        FAIL_TOO_DISTANT: (255, 0, 0),       # red
    }
    for code, rgb in colors.items():
        img[r == code] = rgb
    _save(path, img)


def _flow_color_wheel() -> np.ndarray:
    """Middlebury flow color wheel (drawOpticalFlow,
    wass_stereo.cpp:1398-1466): 55 hue steps with perceptually-chosen
    transition lengths."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    cols = []
    for i in range(RY):
        cols.append((255, 255 * i // RY, 0))
    for i in range(YG):
        cols.append((255 - 255 * i // YG, 255, 0))
    for i in range(GC):
        cols.append((0, 255, 255 * i // GC))
    for i in range(CB):
        cols.append((0, 255 - 255 * i // CB, 255))
    for i in range(BM):
        cols.append((255 * i // BM, 0, 255))
    for i in range(MR):
        cols.append((255, 0, 255 - 255 * i // MR))
    return np.array(cols, np.float32)


def render_flow(path, flow: np.ndarray, max_motion: float = -1.0) -> None:
    """Flow-field visualization with the Middlebury color coding
    (saturation encodes magnitude, hue encodes direction)."""
    fx = flow[..., 0]
    fy = flow[..., 1]
    ok = np.isfinite(fx) & np.isfinite(fy) & (np.abs(fx) < 1e9) & (np.abs(fy) < 1e9)
    rad = np.sqrt(fx * fx + fy * fy)
    maxrad = max_motion if max_motion > 0 else max(1.0, np.nanmax(np.where(ok, rad, 0)))
    fx = np.where(ok, fx / maxrad, 0)
    fy = np.where(ok, fy / maxrad, 0)
    rad = np.sqrt(fx * fx + fy * fy)

    wheel = _flow_color_wheel()
    ncols = len(wheel)
    a = np.arctan2(-fy, -fx) / np.pi
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = (fk - np.floor(fk))[..., None]
    col = (wheel[k0] * (1 - f) + wheel[k1] * f) / 255.0
    small = rad <= 1
    col = np.where(small[..., None], 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.where(ok[..., None], col * 255.0, 0.0)
    _save(path, img)
