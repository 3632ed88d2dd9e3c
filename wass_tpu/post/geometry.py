"""Surface geometry analytics: slopes/normals and occlusion masks.

Ports of /root/reference/postproc/wasspost/geometry.py:

* compute_slope_and_normals (:5-17): np.gradient slopes + upward normals;
* compute_occlusion_mask (:21-100): per-grid-point ray marching over the
  elevation field.  The reference steps a shrinking seed list; here the
  march is a fixed-bound lax.while_loop over the *full* ray batch with
  an active mask (dead rays simply stop contributing), keeping shapes
  static.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def compute_slope_and_normals(XX: np.ndarray, YY: np.ndarray, ZZ: np.ndarray):
    dx = XX[0, 1] - XX[0, 0]
    dy = YY[1, 0] - YY[0, 0]
    slope_y, slope_x = np.gradient(ZZ, dy, dx)
    slope = np.dstack([slope_x, slope_y])
    normals = np.dstack([slope_x, slope_y, -np.ones_like(ZZ)])
    normals = -normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    return slope, normals


@partial(jax.jit, static_argnames=("max_steps",))
def _occlusion_device(ZZ: jnp.ndarray, ray_d: jnp.ndarray, max_steps: int):
    H, W = ZZ.shape
    maxz = jnp.max(ZZ)

    # Normalize so the dominant horizontal component steps one cell.
    denom = jnp.maximum(jnp.max(jnp.abs(ray_d[..., :2]), axis=-1, keepdims=True), 1e-12)
    d = (ray_d / denom).reshape(-1, 3)

    xx, yy = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32), jnp.arange(H, dtype=jnp.float32))
    px = xx.reshape(-1)
    py = yy.reshape(-1)
    pz = ZZ.reshape(-1)

    def cond(state):
        i, px, py, pz, occ, active = state
        return (i < max_steps) & jnp.any(active)

    def body(state):
        i, px, py, pz, occ, active = state
        px = px + d[:, 0]
        py = py + d[:, 1]
        pz = pz + d[:, 2]
        xi = jnp.round(px).astype(jnp.int32)
        yi = jnp.round(py).astype(jnp.int32)
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (pz <= maxz)
        active = active & inb
        z = ZZ[jnp.clip(yi, 0, H - 1), jnp.clip(xi, 0, W - 1)]
        hit = active & (z >= pz)
        occ = occ | hit
        active = active & ~hit
        return i + 1, px, py, pz, occ, active

    n = H * W
    occ0 = jnp.zeros(n, bool)
    active0 = jnp.ones(n, bool)
    _, _, _, _, occ, _ = jax.lax.while_loop(cond, body, (0, px, py, pz, occ0, active0))
    return occ.reshape(H, W)


def compute_occlusion_mask(ZZ: np.ndarray, ray_d: np.ndarray, invert_y_axis: bool = False) -> np.ndarray:
    """Occlusion mask: 1 where the ray from each surface point intersects
    the surface again (point is occluded along that direction)."""
    assert ray_d.shape == ZZ.shape + (3,)
    assert np.nanmin(ray_d[..., 2]) > 0, "rays must go upward"
    rd = np.array(ray_d, np.float64)
    if invert_y_axis:
        rd[..., 1] *= -1
    max_steps = int(2 * max(ZZ.shape))
    occ = _occlusion_device(jnp.asarray(ZZ, jnp.float32), jnp.asarray(rd, jnp.float32), max_steps)
    return np.asarray(occ).astype(np.uint8)


# --- batched (frame-slab) path ----------------------------------------------
# The reference batches visibility frames across a thread pool
# (/root/reference/postproc/wasspost/wasspost.py:617-621); here a whole
# frame slab runs as ONE device program: the ray march while_loop carries
# every ray of every frame in the slab, and incidence angles are computed
# on device in the same call.


@partial(jax.jit, static_argnames=("max_steps",))
def _visibility_device_batch(ZZ: jnp.ndarray, cam: jnp.ndarray, XX: jnp.ndarray, YY: jnp.ndarray, max_steps: int):
    """ZZ: (B, H, W) elevations in *grid-cell units* (z / dx); cam: (3,)
    camera center with z in the same units; XX/YY in grid-cell units.
    Returns (occ (B, H, W) bool, incidence degrees (B, H, W) f32)."""
    B, H, W = ZZ.shape
    maxz = jnp.max(ZZ, axis=(1, 2))  # (B,)

    rays = jnp.stack(
        [
            jnp.broadcast_to(cam[0] - XX, (B, H, W)),
            jnp.broadcast_to(cam[1] - YY, (B, H, W)),
            jnp.maximum(cam[2] - ZZ, 1e-3),
        ],
        axis=-1,
    )
    rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)

    # Incidence vs the surface normal (wasspost.py:570-575).  Central
    # differences like np.gradient, in physical units (divide by dx).
    def grad(a, axis):
        up = jnp.roll(a, -1, axis)
        dn = jnp.roll(a, 1, axis)
        interior = (up - dn) * 0.5
        # One-sided at borders.
        idx = jnp.arange(a.shape[axis])
        first = jnp.take(a, jnp.array([1]), axis) - jnp.take(a, jnp.array([0]), axis)
        last = jnp.take(a, jnp.array([a.shape[axis] - 1]), axis) - jnp.take(a, jnp.array([a.shape[axis] - 2]), axis)
        shape = [1, 1, 1]
        shape[axis] = a.shape[axis]
        ii = idx.reshape(shape)
        out = jnp.where(ii == 0, first, interior)
        return jnp.where(ii == a.shape[axis] - 1, last, out)

    sx = grad(ZZ, 2) / (XX[0, 1] - XX[0, 0])
    sy = grad(ZZ, 1) / (YY[1, 0] - YY[0, 0])
    normals = jnp.stack([sx, sy, -jnp.ones_like(ZZ)], axis=-1)
    normals = -normals / jnp.linalg.norm(normals, axis=-1, keepdims=True)
    inc = jnp.degrees(jnp.arccos(jnp.clip(jnp.sum(normals * rays, -1), -1.0, 1.0)))

    # Ray march, all B*H*W rays in one while_loop.
    denom = jnp.maximum(jnp.max(jnp.abs(rays[..., :2]), axis=-1, keepdims=True), 1e-12)
    d = (rays / denom).reshape(-1, 3)
    xx = jnp.broadcast_to(jnp.arange(W, dtype=jnp.float32)[None, None, :], (B, H, W))
    yy = jnp.broadcast_to(jnp.arange(H, dtype=jnp.float32)[None, :, None], (B, H, W))
    px = xx.reshape(-1)
    py = yy.reshape(-1)
    pz = ZZ.reshape(-1)
    fb = (jnp.arange(B * H * W, dtype=jnp.int32) // (H * W))  # frame of each ray
    zflat = ZZ.reshape(-1)
    maxz_r = maxz[fb]

    def cond(state):
        i, px, py, pz, occ, active = state
        return (i < max_steps) & jnp.any(active)

    def body(state):
        i, px, py, pz, occ, active = state
        px = px + d[:, 0]
        py = py + d[:, 1]
        pz = pz + d[:, 2]
        xi = jnp.round(px).astype(jnp.int32)
        yi = jnp.round(py).astype(jnp.int32)
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (pz <= maxz_r)
        active = active & inb
        flat = fb * (H * W) + jnp.clip(yi, 0, H - 1) * W + jnp.clip(xi, 0, W - 1)
        z = zflat[flat]
        hit = active & (z >= pz)
        occ = occ | hit
        active = active & ~hit
        return i + 1, px, py, pz, occ, active

    n = B * H * W
    occ0 = jnp.zeros(n, bool)
    active0 = jnp.ones(n, bool)
    _, _, _, _, occ, _ = jax.lax.while_loop(cond, body, (0, px, py, pz, occ0, active0))
    occ = occ.reshape(B, H, W) | (inc >= 88.0)
    return occ, inc


def compute_visibility_batch(
    ZZ_slab: np.ndarray, XX: np.ndarray, YY: np.ndarray, cam_center: np.ndarray, dx: float
):
    """Occlusion masks + incidence angles for a slab of frames in one
    device program.  ZZ_slab (B, H, W) and cam_center/XX/YY in meters;
    internally scaled to grid-cell units like the reference
    (wasspost.py:581-583).  Returns (occ u8 (B, H, W), inc f32)."""
    inv = 1.0 / dx
    occ, inc = _visibility_device_batch(
        jnp.asarray(ZZ_slab * inv, jnp.float32),
        jnp.asarray(np.asarray(cam_center, np.float64) * inv, jnp.float32),
        jnp.asarray(XX * inv, jnp.float32),
        jnp.asarray(YY * inv, jnp.float32),
        int(2 * max(ZZ_slab.shape[1:])),
    )
    return np.asarray(occ).astype(np.uint8), np.asarray(inc, np.float32)
