"""Zero-aware morphology and median filtering for disparity maps.

Device-side forms of the reference's hand-rolled disparity filters:
matrix_dilate_zero / matrix_erode_zero
(/root/reference/src/wass_stereo/wass_stereo.cpp:617-712) and the
cv::medianBlur call (:941-945).  "Zero" is the invalid-disparity marker, so
these are really validity-mask morphology with value infill.

All filters are built from static shifted views (jnp.pad + slicing), which
XLA fuses into a single vectorized stencil — no gathers, no Python loops
over pixels.
"""

from __future__ import annotations

import jax.numpy as jnp


def _shifted_stack_8(x: jnp.ndarray) -> jnp.ndarray:
    """The 8 neighbors of each pixel, zero-padded at borders: (8, H, W)."""
    p = jnp.pad(x, ((1, 1), (1, 1)))
    H, W = x.shape
    views = [
        p[0:H, 0:W],      # top-left
        p[0:H, 1 : W + 1],  # top
        p[0:H, 2 : W + 2],  # top-right
        p[1 : H + 1, 0:W],  # left
        p[1 : H + 1, 2 : W + 2],  # right
        p[2 : H + 2, 0:W],  # bottom-left
        p[2 : H + 2, 1 : W + 1],  # bottom
        p[2 : H + 2, 2 : W + 2],  # bottom-right
    ]
    return jnp.stack(views)


def dilate_zero(x: jnp.ndarray) -> jnp.ndarray:
    """Fill zero pixels with the mean of their >0 8-neighbors when more than
    one neighbor is valid (matrix_dilate_zero, wass_stereo.cpp:617-662).

    The reference skips the 1px border (loops run 1..n-1); we reproduce that
    by only filling interior pixels.
    """
    n = _shifted_stack_8(x)
    valid = (n > 0).astype(x.dtype)
    cnt = jnp.sum(valid, axis=0)
    s = jnp.sum(jnp.where(n > 0, n, 0), axis=0)
    fill = jnp.where(cnt > 1, s / jnp.maximum(cnt, 1), 0.0)
    out = jnp.where(x == 0, fill, x)
    # Keep the border untouched, as in the reference.
    interior = jnp.zeros_like(x, dtype=bool).at[1:-1, 1:-1].set(True)
    return jnp.where(interior, out, x)


def erode_zero(x: jnp.ndarray) -> jnp.ndarray:
    """Zero out any pixel with a zero 8-neighbor; border rows/cols are zeroed
    (matrix_erode_zero, wass_stereo.cpp:665-712)."""
    n = _shifted_stack_8(x)
    any_zero = jnp.any(n == 0, axis=0)
    out = jnp.where(any_zero, 0.0, x)
    border = jnp.ones_like(x, dtype=bool).at[1:-1, 1:-1].set(False)
    return jnp.where(border, 0.0, out)


def median_filter(x: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """ksize x ksize median (cv::medianBlur semantics, border replicate).

    Implemented as a sort over the ksize^2 shifted views; for the small
    window sizes used on disparity maps (3..7) the sort network XLA emits
    is cheap and fully vectorized.
    """
    assert ksize % 2 == 1 and ksize >= 3
    r = ksize // 2
    p = jnp.pad(x, ((r, r), (r, r)), mode="edge")
    H, W = x.shape
    views = [
        p[dy : dy + H, dx : dx + W]
        for dy in range(ksize)
        for dx in range(ksize)
    ]
    stack = jnp.stack(views)
    return jnp.sort(stack, axis=0)[(ksize * ksize) // 2]


def sobel(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """3x3 Sobel derivative (cv::Sobel with ksize=3, border replicate)."""
    p = jnp.pad(x, ((1, 1), (1, 1)), mode="edge")
    H, W = x.shape

    def v(dy, dx):
        return p[dy : dy + H, dx : dx + W]

    if axis == 0:  # d/dx
        return (v(0, 2) - v(0, 0)) + 2 * (v(1, 2) - v(1, 0)) + (v(2, 2) - v(2, 0))
    else:  # d/dy
        return (v(2, 0) - v(0, 0)) + 2 * (v(2, 1) - v(0, 1)) + (v(2, 2) - v(0, 2))
