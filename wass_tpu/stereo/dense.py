"""The dense stereo stage: rectify -> SGM -> filter -> triangulate -> plane.

This is the wass_stereo equivalent (call stack SURVEY.md §3.4, reference
main sequence /root/reference/src/wass_stereo/wass_stereo.cpp:1976-2135),
re-architected as one jittable device program per frame plus a thin host
wrapper that computes rectifying homographies (float64 numpy) and performs
file IO.

Conventions (differ deliberately from the reference's mutable left/right
swapping — see docs/design.md):
  * Cameras are always cam0 / cam1 with x_c1 = R x_c0 + T; every output
    (mesh, plane) lives in the *cam0* frame, like an unswapped reference run.
  * base / match: the rectified image roles.  base is the image whose pixel
    grid we iterate (the reference's "right", wass_stereo.cpp:837), match is
    sampled at x - d: base(y, x) ~ match(y, x - d), d > 0.  Roles are chosen
    from the baseline sign exactly like the reference's auto left-right
    swap (wass_stereo.cpp:478-491).
  * T is rescaled to a configurable baseline norm (default 1) like
    load_data (wass_stereo.cpp:360-370), so all 3D outputs are in baseline
    units.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from wass_tpu.core.geometry import homogeneous_transform
from wass_tpu.core.rectify import stereo_rectify_homographies
from wass_tpu.core.triangulate import triangulate_normalized
from wass_tpu.ops.morphology import dilate_zero, erode_zero, median_filter, sobel
from wass_tpu.ops.sampling import warp_homography, resize
from wass_tpu.ops.components import biggest_component_mask, zgap_component_mask
from wass_tpu.stereo.sgm import sgm_disparity
from wass_tpu.stereo.plane import PlaneFit, ransac_find_plane, refine_plane, crop_plane


@dataclasses.dataclass(frozen=True)
class DenseStereoConfig:
    """Static configuration (hashable: it is a jit static argument).

    Field defaults mirror the reference's INCFG defaults
    (wass_stereo.cpp:742-761, 52-84, 1030-1037) with census-cost penalties
    in place of SGBM's SAD-scaled P1/P2.
    """

    num_disp: int = 256
    min_disp: int = 1
    p1: int = 8
    p2: int = 96
    # SGM path count.  5 = the reference's effective aggregation
    # (cv::StereoSGBM default MODE_SGBM: E, W, N, NW, NE paths —
    # wass_stereo.cpp:775 never sets MODE_HH); 8 = full two-pass set.
    # Default 8: at 3 MP the 5-path set lands exactly on the 0.02
    # verify_meshes gate (0.0198) while 8 paths hold 0.0100 — we keep the
    # 2x quality margin.
    directions: int = 8
    census_win: Tuple[int, int] = (7, 9)
    uniqueness_ratio: int = 1
    lr_max_diff: int = -1
    dense_scale: float = 1.0
    disp_dilate_steps: int = 1
    disp_erosion_steps: int = 2
    median_filter_wsize: int = 0
    biggest_component_grad_threshold: float = 0.0  # 0 disables
    min_angle_deg: float = 20.0
    cam_distance: float = 1.0
    discard_burned: bool = True
    zgap_percentile: float = 99.0
    plane_ransac_rounds: int = 400
    plane_ransac_threshold: float = 1.0
    plane_max_distance: float = 1.5
    plane_refine_max_distance: float = 70.0
    plane_weight_by_distance: bool = True
    min_triangulated: int = 100
    random_seed: int = 0
    # Coarse-to-fine disparity windowing (stereo/c2f.py): full-range SGM at
    # 1/c2f_factor resolution bounds a per-row window of c2f_window
    # disparities for the full-res pass.  0 disables (full-range SGM).
    # Active with conforming static shapes (c2f.c2f_supported); shrinks
    # the full-res cost volume by num_disp / c2f_window (the reference's
    # design point is num_disp=640, wass_stereo.cpp:742-744).
    c2f_window: int = 128
    c2f_factor: int = 4
    # Full-range safety net (the reference always searches the whole
    # disparity range, wass_stereo.cpp:742-744): production falls back to
    # full-range SGM for a frame whose coarse windows miss too much —
    # raw window coverage below c2f_min_coverage, or a spatially-coherent
    # off-band population (an object outside its row band; see
    # c2f.compute_row_windows) above c2f_max_offband.
    c2f_min_coverage: float = 0.5
    c2f_max_offband: float = 2e-3
    # Gaussian pre-smoothing of the rectified images before the census
    # transform (stereo/cost.census_transform).  Negative = AUTO
    # (default): estimate the input degradation and pick the
    # measured-passing sigma (prepare/degradation.py) — 0.8 baseline
    # (takes JPEG-q95 elevation error 0.0205 -> 0.0170, inside the 0.02
    # gate, at ~2% clean cost), 1.5 under sensor noise (best measured).
    # Set explicitly (>= 0) to override; 0 disables.
    # (bench/robustness.py dense_knob_sweep.)
    input_smooth_sigma: float = -1.0


class DenseFrameResult(NamedTuple):
    points: jnp.ndarray  # (H, W, 3) cam0-frame points on the base grid
    valid: jnp.ndarray  # (H, W) final validity mask
    plane: jnp.ndarray  # (4,) refined plane in cam0 frame
    plane_ok: jnp.ndarray  # bool
    disparity: jnp.ndarray  # (H, W) filtered disparity (diagnostic)
    n_points: jnp.ndarray  # int: valid points after outlier removal
    # (H, W) uint8 per-pixel triangulation failure code (FAIL_* below;
    # 0 = triangulated) — the color-coded failure map of the reference
    # (wass_stereo.cpp:1114-1119,1378-1383).
    fail_reasons: jnp.ndarray = None


# Failure codes, mirroring the reference's color-coded debug imagery
# (wass_stereo.cpp:1115-1120): the render maps them to the same colors.
FAIL_OK = 0
FAIL_NO_DISPARITY = 1
FAIL_OUTSIDE_IMAGE = 2  # teal
FAIL_OUTSIDE_BBOX = 3  # yellow (ROI / match-column bounds)
FAIL_BURNED = 4  # also yellow (the reference uses the mask color)
FAIL_ANGLE = 5  # green
FAIL_TOO_CLOSE = 6  # blue
FAIL_TOO_DISTANT = 7  # red


# --------------------------------------------------------------------------
# Host-side geometry setup
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FrameGeometry:
    """Per-frame rectification data (host, float64)."""

    H_base: np.ndarray
    H_match: np.ndarray
    Hi_base: np.ndarray
    Hi_match: np.ndarray
    roi: Tuple[int, int, int, int]
    base_is_cam0: bool
    R: np.ndarray  # cam0 -> cam1, baseline-normalized
    T: np.ndarray
    K0: np.ndarray
    K1: np.ndarray


def prepare_frame_geometry(
    K0: np.ndarray,
    K1: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    image_size: Tuple[int, int],
    cam_distance: float = 1.0,
    angle_deg: float = 0.0,
) -> FrameGeometry:
    """Baseline normalization + role selection + rectifying homographies."""
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    T = T / np.linalg.norm(T) * cam_distance  # load_data T rescale (:360-370)
    C1_in_0 = -R.T @ T  # cam1 center in cam0 frame

    if C1_in_0[0] > 0:
        # cam1 sits in +x of cam0: cam0 sees content shifted right => cam0
        # is the base ("right" in reference terms after its auto-swap).
        base_is_cam0 = True
        res = stereo_rectify_homographies(K0, K1, R.T, C1_in_0, image_size, angle_deg=angle_deg)
        H_base, H_match = res.HL, res.HR
    else:
        base_is_cam0 = False
        res = stereo_rectify_homographies(K1, K0, R, T, image_size, angle_deg=angle_deg)
        H_base, H_match = res.HL, res.HR

    return FrameGeometry(
        H_base=H_base,
        H_match=H_match,
        Hi_base=np.linalg.inv(H_base),
        Hi_match=np.linalg.inv(H_match),
        roi=res.roi,
        base_is_cam0=base_is_cam0,
        R=R,
        T=T,
        K0=np.asarray(K0, np.float64),
        K1=np.asarray(K1, np.float64),
    )


# --------------------------------------------------------------------------
# Device-side stages
# --------------------------------------------------------------------------


def _c2f_active(cfg: DenseStereoConfig, shape) -> bool:
    """Coarse-to-fine windowing engages when it is enabled and the static
    shapes conform (stereo/c2f.py)."""
    if cfg.c2f_window <= 0:
        return False
    from wass_tpu.stereo.c2f import c2f_supported

    H, W = shape
    if cfg.dense_scale != 1.0:
        H, W = round(H * cfg.dense_scale), round(W * cfg.dense_scale)
    return c2f_supported(
        H, W, cfg.num_disp, cfg.c2f_window, cfg.c2f_factor, cfg.directions,
        cfg.lr_max_diff,
    )


def _dispatch_disparity(base_s: jnp.ndarray, match_s: jnp.ndarray, cfg: DenseStereoConfig) -> jnp.ndarray:
    """Full-range SGM or the coarse-to-fine windowed path (monolithic-jit
    callers; the fine-grained production pipeline has its own dispatch)."""
    if _c2f_active(cfg, base_s.shape):
        from wass_tpu.stereo.c2f import sgm_disparity_c2f

        return sgm_disparity_c2f(
            base_s,
            match_s,
            num_disp=cfg.num_disp,
            min_disp=cfg.min_disp,
            P1=cfg.p1,
            P2=cfg.p2,
            directions=cfg.directions,
            census_win=cfg.census_win,
            uniqueness_ratio=cfg.uniqueness_ratio,
            factor=cfg.c2f_factor,
            win_disp=cfg.c2f_window,
            input_smooth_sigma=cfg.input_smooth_sigma,
        )
    return sgm_disparity(
        base_s,
        match_s,
        num_disp=cfg.num_disp,
        min_disp=cfg.min_disp,
        P1=cfg.p1,
        P2=cfg.p2,
        directions=cfg.directions,
        census_win=cfg.census_win,
        uniqueness_ratio=cfg.uniqueness_ratio,
        lr_max_diff=cfg.lr_max_diff,
        input_smooth_sigma=cfg.input_smooth_sigma,
    )


def disparity_postprocess(disp: jnp.ndarray, cfg: DenseStereoConfig) -> jnp.ndarray:
    """The reference's disparity cleanup chain (wass_stereo.cpp:853-991):
    dilate / erode (zero-aware), optional scale-up with the NN+cubic
    validity trick, optional median, optional biggest-component filter."""
    for _ in range(cfg.disp_dilate_steps):
        disp = dilate_zero(disp)
    for _ in range(cfg.disp_erosion_steps):
        disp = erode_zero(disp)

    if cfg.dense_scale != 1.0:
        H, W = disp.shape
        full = (round(H / cfg.dense_scale), round(W / cfg.dense_scale))
        nn = resize(disp, full, interp="nearest")
        cub = resize(disp, full, interp="cubic")
        nn = erode_zero(nn)
        disp = jnp.where(nn == 0, 0.0, cub) / cfg.dense_scale

    if cfg.median_filter_wsize >= 3:
        disp = median_filter(disp, cfg.median_filter_wsize)

    if cfg.biggest_component_grad_threshold > 0:
        gx = sobel(disp, 0)
        gy = sobel(disp, 1)
        gmag = gx * gx + gy * gy
        disp = jnp.where(gmag > cfg.biggest_component_grad_threshold, 0.0, disp)
        keep = biggest_component_mask(disp != 0)
        disp = jnp.where(keep, disp, 0.0)

    return disp


def burned_match_mask(disp: jnp.ndarray, bm: jnp.ndarray, min_disp: int, num_disp: int) -> jnp.ndarray:
    """burned[y, x] = bm[y, x - round(disp[y, x])]: is the match pixel a
    base pixel samples saturated?  (DISCARD_BURNED_AREAS semantics on the
    rectified match image, wass_stereo.cpp:1069-1093.)

    Evaluated without 2-D gathers as a masked-select over rolled copies of
    bm; the roll loop is a lax.fori_loop (a Python unroll at D=640 bloats
    the traced graph and the compile), and the roll's wraparound is
    masked with a column iota so a saturated region at the right image
    edge never invalidates pixels near the left edge."""
    W = bm.shape[1]
    di = jnp.round(disp).astype(jnp.int32)
    xx = jnp.arange(W, dtype=jnp.int32)[None, :]
    bm8 = bm.astype(jnp.uint8)

    def body(k, acc):
        hit = (di == k) & (xx >= k) & (jnp.roll(bm8, k, axis=1) != 0)
        return acc | hit

    return jax.lax.fori_loop(
        min_disp, min_disp + num_disp, body, jnp.zeros_like(bm)
    )


def triangulate_dense(
    disp: jnp.ndarray,
    geom_pack: dict,
    base_rect: jnp.ndarray,
    match_rect: jnp.ndarray,
    cfg: DenseStereoConfig,
):
    """Per-pixel triangulation with the reference's validity gates
    (wass_stereo.cpp:1173-1373) as one masked batch.

    geom_pack carries device arrays: Hi_base, Hi_match (3,3), K0, K1 (3,3),
    R (3,3), T (3), base_is_cam0 (bool), roi mask (H, W).
    """
    H, W = disp.shape
    xx = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)

    # Failure-reason map (reference color-coded debug imagery,
    # wass_stereo.cpp:1114-1119,1378-1383): pre-triangulation gates
    # overwrite in evaluation order like the reference's dbg writes; the
    # post-triangulation distance gates only mark still-valid pixels.
    valid = disp > cfg.min_disp
    reasons = jnp.where(valid, FAIL_OK, FAIL_NO_DISPARITY).astype(jnp.uint8)

    valid = valid & geom_pack["roi_mask"]
    reasons = jnp.where(~geom_pack["roi_mask"], FAIL_OUTSIDE_BBOX, reasons)

    xm = xx - disp  # match-image x coordinate
    in_match = (xm >= 0) & (xm < W)
    valid = valid & in_match
    reasons = jnp.where(~in_match, FAIL_OUTSIDE_BBOX, reasons)

    # Unrectify both coordinates (homography route; both rectification
    # methods are expressed as homographies on undistorted inputs).
    uv_base = homogeneous_transform(geom_pack["Hi_base"], jnp.stack([xx, yy], -1))
    uv_match = homogeneous_transform(geom_pack["Hi_match"], jnp.stack([xm, yy], -1))

    # In-image gates (1px margin, :1223-1228).
    for uv in (uv_base, uv_match):
        in_img = (uv[..., 0] >= 1) & (uv[..., 0] < W - 1) & (uv[..., 1] >= 1) & (uv[..., 1] < H - 1)
        valid = valid & in_img
        reasons = jnp.where(~in_img, FAIL_OUTSIDE_IMAGE, reasons)

    # Burned-pixel masks (:1069-1093, DISCARD_BURNED_AREAS).  The reference
    # samples the *original* images at the unrectified coordinates; we
    # evaluate the same criterion on the *rectified* images (linear warps
    # of the originals: a >254 region stays >=254 in its interior).  The
    # base test is elementwise; the match test (burned at column x - d) is
    # a shift-select over the disparity range on a uint8 mask instead of a
    # row gather, and the whole thing runs under a lax.cond so frames
    # with no burned pixels (the common case) skip it.
    if cfg.discard_burned:
        burned_base = base_rect > 254.0
        valid = valid & ~burned_base
        bm = (match_rect > 254.0)
        burned = jax.lax.cond(
            jnp.any(bm),
            lambda _: burned_match_mask(disp, bm, cfg.min_disp, cfg.num_disp),
            lambda _: jnp.zeros_like(bm),
            None,
        )
        valid = valid & ~burned
        reasons = jnp.where(burned_base | burned, FAIL_BURNED, reasons)

    # Normalized coordinates: p in cam0, q in cam1 (roles by base_is_cam0).
    K0 = geom_pack["K0"]
    K1 = geom_pack["K1"]
    base_is_cam0 = geom_pack["base_is_cam0"]
    uv0 = jnp.where(base_is_cam0, uv_base, uv_match)
    uv1 = jnp.where(base_is_cam0, uv_match, uv_base)
    p = jnp.stack(
        [(uv0[..., 0] - K0[0, 2]) / K0[0, 0], (uv0[..., 1] - K0[1, 2]) / K0[1, 1]], -1
    )
    q = jnp.stack(
        [(uv1[..., 0] - K1[0, 2]) / K1[0, 0], (uv1[..., 1] - K1[1, 2]) / K1[1, 1]], -1
    )

    R = geom_pack["R"]
    T = geom_pack["T"]

    # Angle gate (:1257-1269).  The reference computes
    #   d1 = normalize([p_left, 1]),  d2 = normalize(R [q_right, 1] + T)
    # with (R, T) = left->right a.k.a. match->base; this is *not* the ray
    # parallax angle (which would be ~ baseline/distance, a few degrees) but
    # a baseline-mixed heuristic — reproduced literally so the reference's
    # TRIANG_MIN_ANGLE default keeps its meaning.
    p_match = jnp.where(geom_pack["base_is_cam0"], q, p)
    q_base = jnp.where(geom_pack["base_is_cam0"], p, q)
    R_mb = geom_pack["R_mb"]
    T_mb = geom_pack["T_mb"]
    d1 = jnp.concatenate([p_match, jnp.ones_like(p_match[..., :1])], -1)
    d1 = d1 / jnp.linalg.norm(d1, axis=-1, keepdims=True)
    # HIGHEST: the angle gate thresholds this product (TF32 would move it).
    d2 = jnp.matmul(
        jnp.concatenate([q_base, jnp.ones_like(q_base[..., :1])], -1), R_mb.T,
        precision=jax.lax.Precision.HIGHEST,
    ) + T_mb
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    ang = jnp.degrees(jnp.arccos(jnp.clip(jnp.sum(d1 * d2, -1), -1.0, 1.0)))
    if cfg.min_angle_deg > 0:
        ang_ok = jnp.abs(ang) >= cfg.min_angle_deg
        valid = valid & ang_ok
        reasons = jnp.where(~ang_ok, FAIL_ANGLE, reasons)

    pts = triangulate_normalized(p, q, R, T)

    # Distance gates (:1327-1340) in baseline units; like the reference
    # these only apply to pixels that reached triangulation.
    dist = jnp.linalg.norm(pts, axis=-1)
    too_close = (dist < cfg.cam_distance / 10.0) | (pts[..., 2] < 1.0)
    too_far = (dist > cfg.cam_distance * 200.0) | ~(pts[..., 2] < 1e30)
    reasons = jnp.where((reasons == FAIL_OK) & too_close, FAIL_TOO_CLOSE, reasons)
    reasons = jnp.where((reasons == FAIL_OK) & too_far, FAIL_TOO_DISTANT, reasons)
    valid = valid & ~too_close & ~too_far

    return pts, valid, reasons


def _masked_percentile_bisect(values: jnp.ndarray, mask: jnp.ndarray, pct: float, iters: int = 20) -> jnp.ndarray:
    """Approximate masked percentile by bisection on the value axis: each
    iteration is one masked count-below reduction over the array — no sort,
    no scatter (both were compile/runtime pathologies at 3 MP)."""
    total = jnp.maximum(jnp.sum(mask), 1)
    target = (pct / 100.0) * total
    hi0 = jnp.max(jnp.where(mask, values, 0.0))

    def body(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum(jnp.where(mask, values <= mid, False))
        below = cnt < target
        return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (jnp.zeros_like(hi0), hi0))
    return hi


def outlier_removal(pts: jnp.ndarray, valid: jnp.ndarray, cfg: DenseStereoConfig):
    """Z-gap percentile + biggest z-gap-gated component
    (compute_zgap_percentile PovMesh.cpp:888-927 + cluster :929-987)."""
    z = pts[..., 2]
    gaps = []
    masks = []
    # Upper-row neighbor gaps (A, B, C = up-left, up, up-right).
    for dx in (-1, 0, 1):
        shifted_z = jnp.roll(z, (1, -dx), axis=(0, 1))
        shifted_v = jnp.roll(valid, (1, -dx), axis=(0, 1))
        g = jnp.abs(z - shifted_z)
        m = valid & shifted_v
        m = m.at[0, :].set(False)
        if dx == -1:
            m = m.at[:, -1].set(False)
        elif dx == 1:
            m = m.at[:, 0].set(False)
        gaps.append(g)
        masks.append(m)
    allgaps = jnp.stack(gaps)
    allmasks = jnp.stack(masks)
    zgap = _masked_percentile_bisect(allgaps, allmasks, cfg.zgap_percentile)
    keep = zgap_component_mask(z, valid, zgap)
    return keep, zgap


@partial(jax.jit, static_argnames=("cfg",))
def dense_stereo_device(
    base_rect: jnp.ndarray,
    match_rect: jnp.ndarray,
    base_img: jnp.ndarray,
    match_img: jnp.ndarray,
    geom_pack: dict,
    cfg: DenseStereoConfig,
) -> DenseFrameResult:
    """The full on-device dense pipeline for one frame pair (rectified
    images in, cam0-frame point grid + plane out)."""
    if cfg.dense_scale != 1.0:
        h, w = base_rect.shape
        sh, sw = round(h * cfg.dense_scale), round(w * cfg.dense_scale)
        base_s = resize(base_rect, (sh, sw), interp="cubic")
        match_s = resize(match_rect, (sh, sw), interp="cubic")
    else:
        base_s, match_s = base_rect, match_rect

    disp = _dispatch_disparity(base_s, match_s, cfg)
    disp = disparity_postprocess(disp, cfg)

    pts, valid, reasons = triangulate_dense(disp, geom_pack, base_rect, match_rect, cfg)
    n_tri = jnp.sum(valid)

    keep, zgap = outlier_removal(pts, valid, cfg)
    valid = valid & keep

    key = jax.random.PRNGKey(cfg.random_seed)
    fit = ransac_find_plane(
        pts, valid, key, rounds=cfg.plane_ransac_rounds, distance_threshold=cfg.plane_ransac_threshold
    )
    valid_c = crop_plane(fit.plane, pts, valid, cfg.plane_ransac_threshold)
    plane = refine_plane(
        pts,
        valid_c,
        max_distance=cfg.plane_refine_max_distance,
        weight_by_distance=cfg.plane_weight_by_distance,
    )
    # Final crop with the (looser) max-distance threshold (:2063-2088).
    valid = crop_plane(plane, pts, valid, cfg.plane_max_distance)
    valid = jnp.where(fit.ok, valid, valid_c)

    return DenseFrameResult(
        points=pts,
        valid=valid,
        plane=jnp.where(fit.ok, plane, jnp.full(4, jnp.nan)),
        plane_ok=fit.ok,
        disparity=disp,
        n_points=jnp.sum(valid),
        fail_reasons=reasons,
    )


@partial(jax.jit, static_argnames=("cfg",))
def _stage_disparity(base_rect, match_rect, cfg: DenseStereoConfig):
    if cfg.dense_scale != 1.0:
        h, w = base_rect.shape
        sh, sw = round(h * cfg.dense_scale), round(w * cfg.dense_scale)
        base_rect = resize(base_rect, (sh, sw), interp="cubic")
        match_rect = resize(match_rect, (sh, sw), interp="cubic")
    disp = _dispatch_disparity(base_rect, match_rect, cfg)
    return disparity_postprocess(disp, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _stage_points(disp, geom_pack, base_rect, match_rect, cfg: DenseStereoConfig):
    pts, valid, reasons = triangulate_dense(disp, geom_pack, base_rect, match_rect, cfg)
    keep, _ = outlier_removal(pts, valid, cfg)
    return pts, valid & keep, reasons


@partial(jax.jit, static_argnames=("cfg",))
def _stage_plane(pts, valid, cfg: DenseStereoConfig):
    key = jax.random.PRNGKey(cfg.random_seed)
    fit = ransac_find_plane(pts, valid, key, cfg.plane_ransac_rounds, cfg.plane_ransac_threshold)
    valid_c = crop_plane(fit.plane, pts, valid, cfg.plane_ransac_threshold)
    plane = refine_plane(
        pts, valid_c,
        max_distance=cfg.plane_refine_max_distance,
        weight_by_distance=cfg.plane_weight_by_distance,
    )
    valid_f = crop_plane(plane, pts, valid, cfg.plane_max_distance)
    valid_f = jnp.where(fit.ok, valid_f, valid_c)
    return jnp.where(fit.ok, plane, jnp.full(4, jnp.nan)), fit.ok, valid_f


# --- fine-grained jits: the production path ---------------------------------
# One jit per algorithmic step: each compiles and caches on its own, and
# the c2f fallback decision sits between the coarse pass and the fine one.

from wass_tpu.stereo.cost import census_transform as _census, census_cost_volume as _costvol
from wass_tpu.stereo.sgm import aggregate as _aggregate, wta_disparity as _wta


@partial(jax.jit, static_argnames=("win", "smooth_sigma"))
def _jit_census(img, win, smooth_sigma=0.0):
    return _census(img, win, smooth_sigma)


@partial(jax.jit, static_argnames=("num_disp", "min_disp"))
def _jit_cost(cb, cm, num_disp, min_disp, offsets=None):
    return _costvol(cb, cm, num_disp, min_disp, offsets)


@partial(jax.jit, static_argnames=("P1", "P2", "directions"))
def _jit_aggregate(cost, P1, P2, directions, offsets=None):
    return _aggregate(cost, P1, P2, directions, offsets)


@partial(jax.jit, static_argnames=("min_disp", "uniqueness_ratio", "lr_max_diff"))
def _jit_wta(agg, min_disp, uniqueness_ratio, lr_max_diff):
    return _wta(agg, min_disp, uniqueness_ratio, lr_max_diff)


@partial(jax.jit, static_argnames=("cfg",))
def _jit_postprocess(disp, cfg):
    return disparity_postprocess(disp, cfg)


# Coarse-to-fine pieces.


@partial(jax.jit, static_argnames=("cfg",))
def _jit_c2f_coarse(base_rect, match_rect, cfg: DenseStereoConfig):
    from wass_tpu.stereo.c2f import coarse_num_disp, downsample_pool

    bc = downsample_pool(base_rect, cfg.c2f_factor)
    mc = downsample_pool(match_rect, cfg.c2f_factor)
    return sgm_disparity(
        bc, mc,
        num_disp=coarse_num_disp(cfg.num_disp, cfg.c2f_factor),
        min_disp=max(1, cfg.min_disp // cfg.c2f_factor),
        P1=cfg.p1, P2=cfg.p2,
        directions=cfg.directions if cfg.directions != 5 else 8,
        census_win=cfg.census_win,
        uniqueness_ratio=cfg.uniqueness_ratio,
    )


@partial(jax.jit, static_argnames=("cfg",))
def _jit_c2f_windows(disp_c, cfg: DenseStereoConfig):
    from wass_tpu.stereo.c2f import compute_row_windows

    return compute_row_windows(
        disp_c, cfg.c2f_factor, cfg.num_disp, cfg.min_disp, cfg.c2f_window
    )


def c2f_should_fallback(coverage: float, offband: float, cfg: DenseStereoConfig) -> bool:
    """Full-range fallback decision for one frame (pure, host-side)."""
    return coverage < cfg.c2f_min_coverage or offband > cfg.c2f_max_offband


@partial(jax.jit, static_argnames=("uniqueness_ratio",))
def _jit_wta_windowed(agg, off_rows, uniqueness_ratio):
    from wass_tpu.stereo.c2f import wta_disparity_windowed

    return wta_disparity_windowed(agg, off_rows, uniqueness_ratio)


@partial(jax.jit, static_argnames=("cfg",))
def _jit_triangulate(disp, geom_pack, base_rect, match_rect, cfg):
    return triangulate_dense(disp, geom_pack, base_rect, match_rect, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _jit_outlier(pts, valid, cfg):
    keep, _ = outlier_removal(pts, valid, cfg)
    return valid & keep


@jax.jit
def _stage_export(pts, valid, plane):
    """Device-side .xyzC payload: transform the valid points to the
    sea-plane frame, quantize to the format's u16 fixed point
    (PovMesh.cpp:377-460 semantics: scale = 65535/range, truncating cast)
    and compact them to the front of a (H*W, 3) u16 buffer.

    The host then fetches exactly 6*n bytes (+ 6 header floats) instead
    of the 40 MB full f32 point grid + mask (26x less traffic per frame)."""
    from wass_tpu.core.geometry import rt_from_plane

    Rp, Tp, _Rinv, _Tinv = rt_from_plane(plane)
    # HIGHEST: the plane-frame coordinates are quantized to u16 below.
    p = jnp.matmul(pts, Rp.T, precision=jax.lax.Precision.HIGHEST) + Tp
    big = jnp.float32(1e30)
    v3 = valid[..., None]
    flat = p.reshape(-1, 3)
    fv = valid.reshape(-1)
    mins = jnp.min(jnp.where(v3, p, big).reshape(-1, 3), axis=0)
    maxs = jnp.max(jnp.where(v3, p, -big).reshape(-1, 3), axis=0)
    rngs = jnp.where(maxs - mins > 0, maxs - mins, 1.0)
    scales = 65535.0 / rngs
    q = jnp.clip((flat - mins) * scales, 0.0, 65535.0).astype(jnp.uint16)
    HW = fv.shape[0]
    idx = jnp.cumsum(fv) - 1
    target = jnp.where(fv, idx, HW)  # invalid rows dropped
    out = jnp.zeros((HW, 3), jnp.uint16).at[target].set(q, mode="drop")
    return out, mins.astype(jnp.float64), scales.astype(jnp.float64)


@jax.jit
def _stage_export_delta(pts, valid, plane):
    """Device-side .xyzC payload, DELTA-CODED for the wire: same u16
    quantization + compaction as _stage_export, then each compacted point
    is encoded as 3 bytes of per-component delta vs its predecessor
    (consecutive points in the grid scan are a pixel apart in the plane
    frame, so deltas fit i8 almost everywhere), with a sentinel-0 first
    byte marking rare exceptions (row wraps, depth discontinuities, and
    point 0) whose absolute u16 triplets travel in a side stream.

    Wire cost: 3n bytes + 6 bytes/exception (~1-3% of points on
    production-width frames, where one pixel step is ~65535/W <= 32
    quanta in x) — half of _stage_export's 6n.  The host reconstructs
    the EXACT u16 values (io/xyzc.decode_delta_payload) and writes a
    byte-identical .xyzC.  Also returns the direct u16 buffer and the
    exception count, so the finalizer can pick the cheaper stream per
    frame (narrow frames degrade to all-exceptions, where direct wins)."""
    q, mins, scales = _stage_export(pts, valid, plane)
    HW = q.shape[0]
    n = jnp.sum(valid)
    qi = q.astype(jnp.int32)
    d = qi - jnp.roll(qi, 1, axis=0)
    d = d.at[0].set(0)
    # Exception: any component's delta outside the biased-u8 range
    # [-127, 127] (byte 0 is the sentinel), plus point 0 (absolute).
    exc = jnp.any(jnp.abs(d) > 127, axis=1)
    exc = exc.at[0].set(True)
    delta_b = jnp.where(exc[:, None], 0, d + 128).astype(jnp.uint8)
    # Compact the exceptions' absolute u16 triplets, in scan order.
    eidx = jnp.cumsum(exc) - 1
    etarget = jnp.where(exc, eidx, HW)
    exc_vals = jnp.zeros((HW, 3), jnp.uint16).at[etarget].set(q, mode="drop")
    n_exc = jnp.sum(exc & (jnp.arange(HW) < n))
    return delta_b, exc_vals, q, n_exc, mins, scales


@jax.jit
def _jit_disp_u16(disp):
    """Disparity as 1/16-px fixed point for cheap host fetch (the debug
    render does not need f32)."""
    return jnp.clip(disp * 16.0, 0, 65535).astype(jnp.uint16)


@jax.jit
def _jit_u8(img):
    return jnp.clip(img, 0, 255).astype(jnp.uint8)


class DenseStereoPipeline:
    """Fine-grained-jit dense pipeline for production/benchmarking.

    Identical math to dense_stereo_device, compiled as ~8 small XLA
    programs (census x2, cost, SGM aggregation, WTA, postprocess,
    triangulate, outlier, plane); each caches independently, and the
    coarse-to-fine fallback decision runs between them."""

    def __init__(self, cfg: DenseStereoConfig, defer_c2f_fallback: bool = False):
        self.cfg = cfg
        # Per-frame c2f window diagnostics of the most recent __call__:
        # dict(coverage=, offband=, fallback=) or None (c2f inactive).
        # Production (cli/pipeline.py) logs these into wass_stereo_log.txt.
        self.last_c2f: Optional[dict] = None
        # Deferred fallback: __call__ dispatches the windowed fine path
        # unconditionally and leaves coverage/offband as DEVICE scalars in
        # last_c2f (fallback=None) — no host round-trip on the dispatch
        # path.  The caller invokes resolve_fallback() when it consumes
        # the frame (production: in the writer thread, overlapped with
        # the next frames' compute), re-running the rare tripped frame at
        # full range.  Same speculative model as ShardedDenseRunner.
        self.defer_c2f_fallback = defer_c2f_fallback
        self._full_pipe: Optional["DenseStereoPipeline"] = None

    def __call__(self, base_rect, match_rect, base_img, match_img, geom_pack) -> DenseFrameResult:
        cfg = self.cfg
        # AUTO (negative) input_smooth_sigma flows through unresolved: the
        # census level maps the sentinel to the clean-input baseline 0.8,
        # identically in every entry point (ShardedDenseRunner, the
        # monolithic dense_stereo_device, and here).  Genuine degradation
        # estimation happens once per sequence in cli/pipeline.stereo,
        # where the host image is available without a device fetch.
        if cfg.dense_scale != 1.0:
            h, w = base_rect.shape
            sh, sw = round(h * cfg.dense_scale), round(w * cfg.dense_scale)
            base_rect = resize(base_rect, (sh, sw), interp="cubic")
            match_rect = resize(match_rect, (sh, sw), interp="cubic")
        cb = _jit_census(base_rect, cfg.census_win, cfg.input_smooth_sigma)
        cm = _jit_census(match_rect, cfg.census_win, cfg.input_smooth_sigma)
        self.last_c2f = None
        use_c2f = _c2f_active(cfg, base_rect.shape)
        if use_c2f:
            from wass_tpu.stereo.c2f import TILE_ROWS

            disp_c = _jit_c2f_coarse(base_rect, match_rect, cfg)
            wstart, _cov, _offb = _jit_c2f_windows(disp_c, cfg)
            if self.defer_c2f_fallback:
                # No host sync here: keep the diagnostics as device
                # scalars; resolve_fallback() decides later.
                self.last_c2f = {
                    "coverage": _cov, "offband": _offb, "fallback": None,
                }
            else:
                # Host decision point: a scalar sync on the (cheap) coarse
                # pass.  Earlier frames' fine-stage work is still queued on
                # the device, so the dispatch pipeline stays busy.
                cov_v, offb_v = float(_cov), float(_offb)
                fallback = c2f_should_fallback(cov_v, offb_v, cfg)
                self.last_c2f = {
                    "coverage": cov_v, "offband": offb_v, "fallback": fallback,
                }
                use_c2f = not fallback
        if use_c2f:
            off_rows = jnp.repeat(wstart, TILE_ROWS)
            cost = _jit_cost(cb, cm, cfg.c2f_window, 0, off_rows)
            agg = _jit_aggregate(cost, cfg.p1, cfg.p2, cfg.directions, off_rows)
            disp = _jit_wta_windowed(agg, off_rows, cfg.uniqueness_ratio)
        else:
            cost = _jit_cost(cb, cm, cfg.num_disp, cfg.min_disp)
            agg = _jit_aggregate(cost, cfg.p1, cfg.p2, cfg.directions)
            disp = _jit_wta(agg, cfg.min_disp, cfg.uniqueness_ratio, cfg.lr_max_diff)
        disp = _jit_postprocess(disp, cfg)
        pts, valid0, reasons = _jit_triangulate(disp, geom_pack, base_rect, match_rect, cfg)
        valid = _jit_outlier(pts, valid0, cfg)
        plane, ok, valid = _stage_plane(pts, valid, cfg)
        return DenseFrameResult(
            points=pts, valid=valid, plane=plane, plane_ok=ok,
            disparity=disp, n_points=jnp.sum(valid),
            fail_reasons=reasons,
        )

    def resolve_fallback(
        self, res, c2f_info, base_rect, match_rect, base_img, match_img,
        geom_pack,
    ):
        """Consume the deferred c2f diagnostics of one frame: sync the two
        scalars, and if the coverage guard trips, re-run the frame at full
        range (speculation lost only on the rare bad frame).  Returns
        (result, resolved c2f dict)."""
        if c2f_info is None or c2f_info.get("fallback") is not None:
            return res, c2f_info
        cov_v = float(c2f_info["coverage"])
        offb_v = float(c2f_info["offband"])
        fallback = c2f_should_fallback(cov_v, offb_v, self.cfg)
        info = {"coverage": cov_v, "offband": offb_v, "fallback": fallback}
        if fallback:
            if self._full_pipe is None:
                self._full_pipe = DenseStereoPipeline(
                    dataclasses.replace(self.cfg, c2f_window=0)
                )
            res = self._full_pipe(
                base_rect, match_rect, base_img, match_img, geom_pack
            )
        return res, info


def build_geom_pack(geom: "FrameGeometry", image_shape) -> dict:
    """Device-side geometry bundle shared by all dense entry points."""
    H, W = image_shape
    rx, ry, rw, rh = geom.roi
    yy, xx = np.mgrid[0:H, 0:W]
    roi_mask = (xx >= rx) & (xx < rx + rw) & (yy >= ry) & (yy < ry + rh)
    if geom.base_is_cam0:
        R_mb, T_mb = geom.R.T, -geom.R.T @ geom.T
    else:
        R_mb, T_mb = geom.R, geom.T
    return {
        "H_base": jnp.asarray(geom.H_base, jnp.float32),
        "H_match": jnp.asarray(geom.H_match, jnp.float32),
        "Hi_base": jnp.asarray(geom.Hi_base, jnp.float32),
        "Hi_match": jnp.asarray(geom.Hi_match, jnp.float32),
        "K0": jnp.asarray(geom.K0, jnp.float32),
        "K1": jnp.asarray(geom.K1, jnp.float32),
        "R": jnp.asarray(geom.R, jnp.float32),
        "T": jnp.asarray(geom.T, jnp.float32),
        "R_mb": jnp.asarray(R_mb, jnp.float32),
        "T_mb": jnp.asarray(T_mb, jnp.float32),
        "base_is_cam0": jnp.asarray(geom.base_is_cam0),
        "roi_mask": jnp.asarray(roi_mask),
    }


# --------------------------------------------------------------------------
# Host wrapper
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("out_shape", "interp"))
def _jit_warp(img, Hm, out_shape, interp):
    return warp_homography(img, Hm, out_shape, interp=interp)


def rectify_on_device(img: jnp.ndarray, Hm: np.ndarray, out_shape, interp: str = "linear") -> jnp.ndarray:
    """Rectification warp: one jitted bilinear gather warp (compiled once
    per image shape; the homography is an argument).  Linear interpolation
    matches the reference's custom path (cv::warpPerspective default flags,
    wass_stereo.cpp:522-528)."""
    return _jit_warp(img, jnp.asarray(Hm, jnp.float32), tuple(out_shape), interp)


def dense_stereo_frame(
    img0: np.ndarray,
    img1: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    cfg: DenseStereoConfig = DenseStereoConfig(),
) -> Tuple[DenseFrameResult, FrameGeometry]:
    """Host orchestration for a single frame: geometry (f64 host) + the
    jitted device pipeline.  img0/img1 are the *undistorted* cam0/cam1
    images (the wass_prepare outputs)."""
    H, W = img0.shape
    geom = prepare_frame_geometry(K0, K1, R, T, (W, H), cam_distance=cfg.cam_distance)

    if cfg.input_smooth_sigma < 0:
        import dataclasses as _dc

        from wass_tpu.prepare.degradation import resolve_smooth_sigma

        cfg = _dc.replace(
            cfg,
            input_smooth_sigma=resolve_smooth_sigma(
                cfg.input_smooth_sigma, img0, "dense"
            ),
        )

    b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
    b = jnp.asarray(b_img, jnp.float32)
    m = jnp.asarray(m_img, jnp.float32)
    base_rect = rectify_on_device(b, geom.H_base, (H, W))
    match_rect = rectify_on_device(m, geom.H_match, (H, W))

    geom_pack = build_geom_pack(geom, (H, W))
    result = dense_stereo_device(base_rect, match_rect, b, m, geom_pack, cfg)
    return result, geom
