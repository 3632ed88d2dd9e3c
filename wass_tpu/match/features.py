"""Multiscale feature detection + descriptors, fixed-shape and batched.

Functional counterpart of FeatureSet
(/root/reference/src/wass_match/FeatureSet.cpp): the reference runs OpenCV
KAZE (nonlinear scale space) then area-stratified subsampling with
min-distance suppression (:176-327).  The contract that matters downstream
is the matcher quality gates (>=400 matches, <=0.5 px epipolar error,
/root/reference/test/verify_matcher.m), not descriptor identity, so we use
a dense, fixed-shape design:

* scale space: Gaussian pyramid at full resolution (separable convolutions
  — XLA-fused stencils);
* detector: scale-normalized determinant-of-Hessian, 3x3x3 non-max
  suppression — everything dense, no per-keypoint control flow;
* spatial spreading: per-cell arg-max on a coarse grid (replaces the
  sequential min-distance suppression: a cell winner is >= cell-size apart)
  followed by area-stratified global top-k (AREA_SUBDIVISION equivalent);
* descriptor: upright SURF-style 64-d (4x4 subregions x [sum dx, sum |dx|,
  sum dy, sum |dy|]) from bilinear gradient gathers, vmapped over
  keypoints;
* fixed capacity: always returns MAX_FEATURES slots + a validity mask.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp



class FeatureSet(NamedTuple):
    xy: jnp.ndarray  # (K, 2) pixel coords
    scale: jnp.ndarray  # (K,) detection scale (sigma, px)
    angle: jnp.ndarray  # (K,) orientation in radians
    response: jnp.ndarray  # (K,)
    desc: jnp.ndarray  # (K, 64) L2-normalized descriptors
    valid: jnp.ndarray  # (K,) bool


def _gauss_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _gauss_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gauss_kernel1d(sigma, radius)
    pad = jnp.pad(img, ((radius, radius), (0, 0)), mode="edge")
    v = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"), in_axes=1, out_axes=1)(pad)
    pad = jnp.pad(v, ((0, 0), (radius, radius)), mode="edge")
    h = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"), in_axes=0, out_axes=0)(pad)
    return h


def _hessian_response(smoothed: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Scale-normalized determinant of Hessian (sigma^4 |H|)."""
    dy, dx = jnp.gradient(smoothed)
    dyy, dyx = jnp.gradient(dy)
    dxy, dxx = jnp.gradient(dx)
    det = dxx * dyy - dxy * dyx
    return (sigma**4) * det


def build_scale_space(img: jnp.ndarray, n_scales: int = 8, sigma0: float = 1.6, step: float = 1.45):
    sigmas = [sigma0 * step**i for i in range(n_scales)]
    smoothed = [_gauss_blur(img, s) for s in sigmas]
    responses = jnp.stack([_hessian_response(sm, s) for sm, s in zip(smoothed, sigmas)])
    return jnp.stack(smoothed), responses, jnp.asarray(sigmas, jnp.float32)


def _nms3d(resp: jnp.ndarray) -> jnp.ndarray:
    """3x3x3 non-max suppression over (S, H, W); border scales compare with
    what exists."""
    S, H, W = resp.shape
    p = jnp.pad(resp, ((1, 1), (1, 1), (1, 1)), constant_values=-jnp.inf)
    is_max = jnp.ones_like(resp, dtype=bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                neigh = p[1 + ds : 1 + ds + S, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
                is_max = is_max & (resp >= neigh)
    return is_max


@partial(jax.jit, static_argnames=("max_features", "n_scales", "grid_cell", "area_subdivision", "border_frac"))
def detect_features(
    img: jnp.ndarray,
    max_features: int = 2000,
    hessian_threshold: float = 1e-5,
    n_scales: int = 8,
    grid_cell: int = 12,
    area_subdivision: int = 5,
    border_frac: float = 1.0 / 30.0,
) -> FeatureSet:
    """Detect up to max_features features with area-stratified selection.

    grid_cell plays the role of FEATURE_MIN_DISTANCE (10 px default,
    FeatureSet.cpp:42): one winner per grid_cell x grid_cell block.
    area_subdivision mirrors AREA_SUBDIVISION (:47).
    """
    H, W = img.shape
    img = img.astype(jnp.float32) / 255.0
    smoothed, responses, sigmas = build_scale_space(img, n_scales)

    is_max = _nms3d(responses)
    resp_best = jnp.max(jnp.where(is_max, responses, -jnp.inf), axis=0)
    scale_idx = jnp.argmax(jnp.where(is_max, responses, -jnp.inf), axis=0)

    border = jnp.maximum(W * border_frac, 2.0)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, :]
    in_border = (xx > border) & (xx < W - border) & (yy > border) & (yy < H - border)
    cand = (resp_best > hessian_threshold) & in_border

    resp_masked = jnp.where(cand, resp_best, -jnp.inf)

    # --- grid suppression: keep the best candidate per cell ----------------
    gh, gw = -(-H // grid_cell), -(-W // grid_cell)
    padded = jnp.full((gh * grid_cell, gw * grid_cell), -jnp.inf).at[:H, :W].set(resp_masked)
    cells = padded.reshape(gh, grid_cell, gw, grid_cell).transpose(0, 2, 1, 3).reshape(gh, gw, -1)
    cell_best = jnp.argmax(cells, axis=-1)
    cell_resp = jnp.max(cells, axis=-1)
    cell_y = cell_best // grid_cell + jnp.arange(gh)[:, None] * grid_cell
    cell_x = cell_best % grid_cell + jnp.arange(gw)[None, :] * grid_cell

    # --- area-stratified top-k --------------------------------------------
    # Rank cells within each of area_subdivision^2 areas by response, then
    # round-robin across areas (FeatureSet.cpp:281-320's interleaving) by
    # ordering on (per-area rank, -response).
    n_areas = area_subdivision
    area_id = (cell_y * n_areas // max(H, 1)) * n_areas + (cell_x * n_areas // max(W, 1))
    flat_resp = cell_resp.reshape(-1)
    flat_area = area_id.reshape(-1)
    order = jnp.argsort(-flat_resp)
    sorted_area = flat_area[order]
    # Rank within area = occurrences of the same area before this position.
    onehot = jax.nn.one_hot(sorted_area, n_areas * n_areas, dtype=jnp.int32)
    rank_in_area = (jnp.cumsum(onehot, axis=0) - 1)[jnp.arange(sorted_area.shape[0]), sorted_area]
    sorted_resp = flat_resp[order]
    key = jnp.where(jnp.isfinite(sorted_resp), rank_in_area, jnp.iinfo(jnp.int32).max)
    rr_order = jnp.argsort(key, stable=True)
    selection = order[rr_order][:max_features]

    sel_y = cell_y.reshape(-1)[selection]
    sel_x = cell_x.reshape(-1)[selection]
    sel_resp = flat_resp[selection]
    valid = jnp.isfinite(sel_resp)
    sel_y = jnp.clip(sel_y, 0, H - 1)
    sel_x = jnp.clip(sel_x, 0, W - 1)
    sel_scale = sigmas[scale_idx[sel_y, sel_x]]

    # --- subpixel: 2D quadratic on the response at the detected scale -----
    # Five point taps gathered directly from the (S, H, W) response stack:
    # indexing the per-feature plane first (responses[sidx] under vmap)
    # would materialize a (max_features, H, W) gather — 14 GB at
    # 1536x1152 x 2000 features.
    sel_sidx = scale_idx[sel_y, sel_x]

    def rtap(dy, dx):
        return responses[
            sel_sidx,
            jnp.clip(sel_y + dy, 0, H - 1),
            jnp.clip(sel_x + dx, 0, W - 1),
        ]

    c = rtap(0, 0)
    dxm, dxp = rtap(0, -1), rtap(0, 1)
    dym, dyp = rtap(-1, 0), rtap(1, 0)
    ox = jnp.clip((dxm - dxp) / (2 * jnp.abs(dxm + dxp - 2 * c) + 1e-12), -0.5, 0.5)
    oy = jnp.clip((dym - dyp) / (2 * jnp.abs(dym + dyp - 2 * c) + 1e-12), -0.5, 0.5)
    xy = jnp.stack([sel_x + ox, sel_y + oy], axis=-1)

    # --- orientation + descriptor -----------------------------------------
    # Gradients of the most-smoothed-at-that-scale image.
    angle, desc = _describe(smoothed, sigmas, xy, sel_sidx)

    return FeatureSet(
        xy=xy.astype(jnp.float32),
        scale=sel_scale,
        angle=angle,
        response=jnp.where(valid, sel_resp, 0.0),
        desc=desc,
        valid=valid,
    )


def _describe(smoothed: jnp.ndarray, sigmas: jnp.ndarray, xy: jnp.ndarray, sidx: jnp.ndarray):
    """Upright SURF-style 64-d descriptors + gradient orientation.

    Samples a 16x16 grid spanning 20*sigma around each keypoint from the
    per-scale smoothed images; 4x4 subregions x (sum dx, sum |dx|, sum dy,
    sum |dy|), Gaussian-weighted, L2-normalized.
    """
    S, H, W = smoothed.shape
    G = 16  # sample grid
    span = 20.0

    offs = (jnp.arange(G, dtype=jnp.float32) - (G - 1) / 2) / G * span  # in sigma units
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")

    gw = jnp.exp(-0.5 * ((ox / (span / 2)) ** 2 + (oy / (span / 2)) ** 2) * 4.0)

    # Per-feature plane selection happens inside the gather (row offset
    # si*H into the (S*H, W)-flattened stack): `smoothed[si]` under vmap
    # materialized an (n_features, H, W) gather — an HBM OOM at full
    # resolution.  Bit-identical to bilinear_sample(smoothed[si], ...):
    # row indices are clipped to the plane before the offset.
    flat = smoothed.reshape(S * H, W)

    def plane_bilinear(si, sx, sy):
        x0 = jnp.floor(sx)
        y0 = jnp.floor(sy)
        fx = sx - x0
        fy = sy - y0
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)
        base = si * H

        def g(yi, xi):
            return flat[jnp.clip(yi, 0, H - 1) + base, jnp.clip(xi, 0, W - 1)]

        top = g(y0i, x0i) * (1 - fx) + g(y0i, x0i + 1) * fx
        bot = g(y0i + 1, x0i) * (1 - fx) + g(y0i + 1, x0i + 1) * fx
        out = top * (1 - fy) + bot * fy
        valid = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
        return jnp.where(valid, out, 0.0)

    def one(xyi, si):
        sig = sigmas[si]
        sx = xyi[0] + ox * sig
        sy = xyi[1] + oy * sig
        eps = jnp.maximum(sig, 1.0)
        vxp = plane_bilinear(si, sx + eps, sy)
        vxm = plane_bilinear(si, sx - eps, sy)
        vyp = plane_bilinear(si, sx, sy + eps)
        vym = plane_bilinear(si, sx, sy - eps)
        dx = (vxp - vxm) * gw
        dy = (vyp - vym) * gw
        ang = jnp.arctan2(jnp.sum(dy), jnp.sum(dx))
        sub = lambda a: a.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(4, 4, 16)
        dxs = sub(dx)
        dys = sub(dy)
        d = jnp.stack(
            [dxs.sum(-1), jnp.abs(dxs).sum(-1), dys.sum(-1), jnp.abs(dys).sum(-1)], axis=-1
        ).reshape(64)
        d = d / jnp.maximum(jnp.linalg.norm(d), 1e-12)
        return ang, d

    angle, desc = jax.vmap(one)(xy, sidx)
    # Wrap to [0, 2pi) like the reference (FeatureSet.cpp:293-296).
    angle = jnp.mod(angle, 2 * jnp.pi)
    return angle, desc
