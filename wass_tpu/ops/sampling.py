"""Batched image sampling / warping / undistortion kernels.

Replacements for the cv::remap / cv::undistort /
cv::warpPerspective / cv::resize calls on the reference's hot paths
(undistort at /root/reference/src/wass_prepare/wass_prepare.cpp:268, rectify
warps at /root/reference/src/wass_stereo/wass_stereo.cpp:522-528,605-607,
resizes at :785-797,895-928).  All functions are pure jnp gathers +
elementwise math: they jit, vmap over frame batches, and differentiate.

Convention: images are (H, W) or (..., H, W) float arrays; coordinates are
(x, y) pixel positions with (0, 0) at the center of the top-left pixel
(OpenCV convention).  Out-of-bounds samples return `fill`.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp


def _gather2d(img: jnp.ndarray, yi: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Clamped integer gather from the last two axes of img."""
    H, W = img.shape[-2], img.shape[-1]
    yi = jnp.clip(yi, 0, H - 1)
    xi = jnp.clip(xi, 0, W - 1)
    return img[..., yi, xi]


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, fill: float = 0.0) -> jnp.ndarray:
    """Bilinear sampling of img at float coords (x, y)."""
    H, W = img.shape[-2], img.shape[-1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    v00 = _gather2d(img, y0i, x0i)
    v01 = _gather2d(img, y0i, x0i + 1)
    v10 = _gather2d(img, y0i + 1, x0i)
    v11 = _gather2d(img, y0i + 1, x0i + 1)

    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy

    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return jnp.where(valid, out, fill)


def bicubic_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, fill: float = 0.0) -> jnp.ndarray:
    """Bicubic (Catmull-Rom style, a=-0.75) sampling at float coords."""
    H, W = img.shape[-2], img.shape[-1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    wx = _cubic_kernel_weights(fx)
    wy = _cubic_kernel_weights(fy)

    out = jnp.zeros(jnp.broadcast_shapes(x.shape, y.shape), img.dtype)
    rows = []
    for j in range(4):
        row = jnp.zeros_like(out)
        for i in range(4):
            row = row + wx[i] * _gather2d(img, y0i + j - 1, x0i + i - 1)
        rows.append(row)
    for j in range(4):
        out = out + wy[j] * rows[j]

    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return jnp.where(valid, out, fill)


def _cubic_kernel_weights(f: jnp.ndarray, a: float = -0.75):
    """Weights for samples at integer offsets (-1, 0, 1, 2) around f in [0,1)."""
    # BiCubic kernel W(x) with A=a evaluated at distances (1+f, f, 1-f, 2-f).
    def k(x):
        ax = jnp.abs(x)
        ax2 = ax * ax
        ax3 = ax2 * ax
        return jnp.where(
            ax <= 1.0,
            (a + 2) * ax3 - (a + 3) * ax2 + 1,
            jnp.where(ax < 2.0, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
        )

    return k(1.0 + f), k(f), k(1.0 - f), k(2.0 - f)


def warp_homography(
    img: jnp.ndarray,
    H: jnp.ndarray,
    out_shape,
    interp: str = "linear",
    fill: float = 0.0,
) -> jnp.ndarray:
    """Warp img by homography H: out(u, v) = img(H^-1 (u, v)).

    Matches cv::warpPerspective(img, out, H, size): H maps source -> dest,
    so sampling uses the inverse map.
    """
    Hi = jnp.linalg.inv(H)
    h, w = out_shape
    u = jnp.arange(w, dtype=img.dtype)
    v = jnp.arange(h, dtype=img.dtype)
    uu, vv = jnp.meshgrid(u, v)
    ww = Hi[2, 0] * uu + Hi[2, 1] * vv + Hi[2, 2]
    ww = jnp.where(jnp.abs(ww) > 1e-20, ww, 1e-20)
    sx = (Hi[0, 0] * uu + Hi[0, 1] * vv + Hi[0, 2]) / ww
    sy = (Hi[1, 0] * uu + Hi[1, 1] * vv + Hi[1, 2]) / ww
    sampler = bilinear_sample if interp == "linear" else bicubic_sample
    return sampler(img, sx, sy, fill=fill)


def distort_points(pts: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Apply the OpenCV rational+tangential distortion model to ideal pixel
    points: ideal (undistorted) pixel coords -> distorted pixel coords.

    dist = (k1, k2, p1, p2[, k3[, k4, k5, k6]]) as in cv::undistort
    (/root/reference/src/wass_prepare/wass_prepare.cpp:268 uses 5-term).
    """
    d = jnp.zeros((8,), pts.dtype).at[: dist.shape[0]].set(dist.reshape(-1))
    k1, k2, p1, p2, k3, k4, k5, k6 = [d[i] for i in range(8)]
    x = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    r2 = x * x + y * y
    radial = (1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2) / (
        1 + k4 * r2 + k5 * r2 * r2 + k6 * r2 * r2 * r2
    )
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return jnp.stack([xd * K[0, 0] + K[0, 2], yd * K[1, 1] + K[1, 2]], axis=-1)


def undistort_points(pts: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Inverse of distort_points by fixed-point iteration (cv::undistortPoints)."""
    d = jnp.zeros((8,), pts.dtype).at[: dist.shape[0]].set(dist.reshape(-1))
    k1, k2, p1, p2, k3, k4, k5, k6 = [d[i] for i in range(8)]
    xd = (pts[..., 0] - K[0, 2]) / K[0, 0]
    yd = (pts[..., 1] - K[1, 2]) / K[1, 1]

    def body(_, xy):
        x, y = xy
        r2 = x * x + y * y
        radial = (1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2) / (
            1 + k4 * r2 + k5 * r2 * r2 + k6 * r2 * r2 * r2
        )
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return ((xd - dx) / radial, (yd - dy) / radial)

    x, y = jax.lax.fori_loop(0, iters, body, (xd, yd))
    return jnp.stack([x * K[0, 0] + K[0, 2], y * K[1, 1] + K[1, 2]], axis=-1)


def undistort_image(img: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray, interp: str = "linear") -> jnp.ndarray:
    """cv::undistort equivalent: for each undistorted output pixel, sample the
    source image at its distorted position (same K for input and output)."""
    H, W = img.shape[-2], img.shape[-1]
    u = jnp.arange(W, dtype=img.dtype)
    v = jnp.arange(H, dtype=img.dtype)
    uu, vv = jnp.meshgrid(u, v)
    src = distort_points(jnp.stack([uu, vv], axis=-1), K, dist)
    sampler = bilinear_sample if interp == "linear" else bicubic_sample
    return sampler(img, src[..., 0], src[..., 1])


def resize(img: jnp.ndarray, out_shape, interp: str = "cubic", fill: float = 0.0) -> jnp.ndarray:
    """cv::resize-compatible resampling (pixel-center aligned scaling).

    interp: "nearest" | "linear" | "cubic".  Matches OpenCV's coordinate
    mapping src_x = (dst_x + 0.5) * sx - 0.5.
    """
    H, W = img.shape[-2], img.shape[-1]
    h, w = out_shape
    sx = W / w
    sy = H / h
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) * sx - 0.5
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) * sy - 0.5
    xx, yy = jnp.meshgrid(xs, ys)
    if interp == "nearest":
        xi = jnp.clip(jnp.floor(xx + 0.5).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.floor(yy + 0.5).astype(jnp.int32), 0, H - 1)
        return _gather2d(img, yi, xi)
    xx = jnp.clip(xx, 0.0, W - 1.0)
    yy = jnp.clip(yy, 0.0, H - 1.0)
    sampler = bilinear_sample if interp == "linear" else bicubic_sample
    return sampler(img, xx.astype(img.dtype), yy.astype(img.dtype), fill=fill)
