"""Contrast-limited adaptive histogram equalization (cv::CLAHE equivalent).

The reference applies CLAHE optionally before undistortion
(/root/reference/src/wass_prepare/wass_prepare.cpp:257-262, options
CAM{0,1}_CLAHE_{CLIPLIMIT,TILEGRIDSIZE} :36-39).

Device shape: per-tile histograms by one scatter-add, clip + uniform excess
redistribution, cumsum CDF -> per-tile LUT, then per-pixel bilinear
interpolation between the four neighboring tile LUTs (a gather).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("tiles_x", "tiles_y", "n_bins"))
def clahe(
    img: jnp.ndarray,
    clip_limit: float = 2.0,
    tiles_x: int = 8,
    tiles_y: int = 8,
    n_bins: int = 256,
) -> jnp.ndarray:
    """Apply CLAHE to a (H, W) uint8-range float image.

    Note: cv::CLAHE's tileGridSize is the number of tiles; the reference's
    CLAHE_TILEGRIDSIZE option (suggested 150) is the *pixel size* of a tile
    — callers convert: tiles = image_size / tile_px.
    """
    H, W = img.shape
    x = jnp.clip(img, 0.0, 255.0)
    bins = jnp.clip((x * (n_bins / 256.0)).astype(jnp.int32), 0, n_bins - 1)

    ty = jnp.minimum((jnp.arange(H) * tiles_y) // H, tiles_y - 1)
    tx = jnp.minimum((jnp.arange(W) * tiles_x) // W, tiles_x - 1)
    tile_id = ty[:, None] * tiles_x + tx[None, :]

    flat_id = (tile_id * n_bins + bins).reshape(-1)
    hist = jnp.zeros((tiles_y * tiles_x * n_bins,), jnp.float32).at[flat_id].add(1.0)
    hist = hist.reshape(tiles_y * tiles_x, n_bins)

    # Clip limit scaled by tile population like OpenCV.
    tile_count = jnp.sum(hist, axis=1, keepdims=True)
    limit = jnp.maximum(clip_limit * tile_count / n_bins, 1.0)
    clipped = jnp.minimum(hist, limit)
    excess = jnp.sum(hist - clipped, axis=1, keepdims=True)
    clipped = clipped + excess / n_bins

    cdf = jnp.cumsum(clipped, axis=1)
    cdf = cdf / jnp.maximum(tile_count, 1.0)
    luts = cdf * 255.0  # (T, n_bins)
    luts = luts.reshape(tiles_y, tiles_x, n_bins)

    # Pixel -> fractional tile coordinates (tile centers at (i+0.5)*size).
    tile_h = H / tiles_y
    tile_w = W / tiles_x
    fy = (jnp.arange(H) + 0.5) / tile_h - 0.5
    fx = (jnp.arange(W) + 0.5) / tile_w - 0.5
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, tiles_y - 1)
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, tiles_x - 1)
    y1 = jnp.clip(y0 + 1, 0, tiles_y - 1)
    x1 = jnp.clip(x0 + 1, 0, tiles_x - 1)
    wy = jnp.clip(fy - y0, 0.0, 1.0)[:, None]
    wx = jnp.clip(fx - x0, 0.0, 1.0)[None, :]

    def lut_at(tyi, txi):
        return luts[tyi[:, None], txi[None, :], bins]

    v00 = lut_at(y0, x0)
    v01 = lut_at(y0, x1)
    v10 = lut_at(y1, x0)
    v11 = lut_at(y1, x1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx)
