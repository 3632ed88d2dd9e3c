"""The sparse matching stage (wass_match equivalent).

Orchestrates: feature detection on both undistorted frames -> matmul kNN
candidates -> game-theoretic match rounds -> essential-matrix RANSAC on
normalized coordinates -> pose recovery -> epipolar-error statistics
(call stack SURVEY.md §3.2 /
/root/reference/src/wass_match/wass_match.cpp:97-375).

Outputs mirror the reference's workdir contract: ext_R / ext_T (x1 = R x0
+ T with |T| = 1 from recoverPose), matches.txt (pose inliers),
matches_epionly.txt (epipolar inliers), matcher_stats.csv.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp


from wass_tpu.match.features import FeatureSet, detect_features
from wass_tpu.match.matcher import generate_candidates, gt_match, nearest_match, payoff_matrix
from wass_tpu.match.pose import relative_pose_ransac


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Defaults from the reference matcher options (wass_match.cpp:39-45,
    FeatureSet.cpp:42-47, GTMatcher.cpp:33)."""

    # Feature budget.  0 = AUTO (default): resolution-scaled — 2000 at
    # <= 1.5 MP (the reference's fixed budget, wass_match.cpp:39) and
    # 4000 above.  The reference's 2000 under-samples megapixel imagery
    # (0.06% of pixels at 3 MP vs 0.26% at 1 MP); 4000 + denser NMS
    # raises the match count at an equal or better epipolar error
    # (bench/_probe_fullres_margin.py).
    num_features: int = 0
    n_candidates_per_feature: int = 3
    nndr: float = 0.25
    matcher_lambda: float = 1e-5
    population_threshold: float = 0.7
    min_group_size: int = 5
    max_rounds: int = 20
    max_epi_distance: float = 0.5  # px
    skip_gt: bool = False
    # Determinant-of-Hessian detection threshold, for responses computed
    # with exact float32 products.  1e-5 holds >= 1.7x the 400-match gate
    # and the pose gates at 1, 3 and 5 MP (bench/_probe_hessian_threshold.py;
    # PERF.md, "Matcher gate on float32 devices").
    hessian_threshold: float = 1e-5
    # Grid-NMS cell size in px.  0 = AUTO: 12 at <= 1.5 MP, 8 above
    # (surface texture scales with resolution, so a fixed 12 px cell
    # caps feature density exactly where the budget grows).
    feature_grid_cell: int = 0
    area_subdivision: int = 5
    ransac_hypotheses: int = 1024
    ransac_confidence: float = 0.9999
    iidyn_iters: int = 20000
    lk_refine: bool = True
    # LK refinement half-window.  0 = auto: scale with image width
    # (7 at 1024 wide), because surface texture scales with resolution —
    # at 2048x1536 a fixed win=7 leaves only ~128 of 690 GT matches
    # within the 0.5 px RANSAC bound, while win~14-15 passes the
    # full-resolution verify_matcher gates (509 matches, 0.149 px f64
    # epi error; measured 2026-08-21).
    lk_win: int = 0
    # Gaussian pre-smoothing of the (uint8 PNG) input images before
    # detection/refinement: the production inputs are 8-bit undistorted
    # frames, whose quantization noise otherwise dominates the subpixel
    # match accuracy (measured 30x worse pose dR on quantized inputs
    # without it).  The reference's KAZE operates on a nonlinear-diffusion
    # smoothed scale space for the same reason (FeatureSet.cpp:199).
    # Negative = AUTO (default): estimate the input's sensor-noise /
    # JPEG-compression level and pick the measured-passing sigma
    # (prepare/degradation.py; 0.8 clean, 1.5 noisy, 2.5 deep JPEG).
    input_smooth_sigma: float = -1.0
    seed: int = 0


class MatchStageResult(NamedTuple):
    R: np.ndarray
    T: np.ndarray
    uv0_all: np.ndarray  # (M, 2) all GT-matcher matches
    uv1_all: np.ndarray
    uv0_epi: np.ndarray  # epipolar-inlier matches
    uv1_epi: np.ndarray
    uv0_pose: np.ndarray  # pose (chirality) inlier matches
    uv1_pose: np.ndarray
    epi_avg: float
    epi_std: float
    epi_min: float
    epi_max: float
    n_matches: int


def match_frame(
    img0: np.ndarray,
    img1: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    cfg: MatchConfig = MatchConfig(),
) -> Optional[MatchStageResult]:
    """Full matching stage for one undistorted frame pair."""
    key = jax.random.PRNGKey(cfg.seed)
    k_match, k_ransac = jax.random.split(key)

    from wass_tpu.prepare.degradation import (
        auto_smooth_sigma,
        classify,
        estimate_degradation,
    )

    half_res = False
    if cfg.input_smooth_sigma < 0:
        est = estimate_degradation(np.asarray(img0))
        smooth_sigma = auto_smooth_sigma(est, "match")
        if classify(est) == "noise_heavy":
            # Heavy sensor noise (sigma >= ~5 gray levels, ~20x this
            # imagery's mean texture gradient): NO full-resolution
            # smoothing level passes the pose gates (bench/robustness.py
            # noise_s8_sweep, 7 variants).  A 2x2 block-mean halves the
            # noise while the swell-scale texture survives: half-res
            # matching at the clean sigma measures pooled dR 2.0e-3 /
            # dT 1.7e-2 at sigma=8 — inside the gates.  Coordinates are
            # mapped back to full resolution before returning.
            half_res = True
            smooth_sigma = 0.8
    else:
        smooth_sigma = float(cfg.input_smooth_sigma)

    if half_res:
        i0 = np.asarray(img0, np.float64)
        i1 = np.asarray(img1, np.float64)
        H2, W2 = (i0.shape[0] // 2) * 2, (i0.shape[1] // 2) * 2

        def _half(a):
            a = a[:H2, :W2]
            return 0.25 * (
                a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2]
            )

        img0, img1 = _half(i0), _half(i1)
        # Exact half-res pixel mapping u_half = S u_full (block centers).
        _S = np.array([[0.5, 0.0, -0.25], [0.0, 0.5, -0.25], [0.0, 0.0, 1.0]])
        K0 = _S @ np.asarray(K0, np.float64)
        K1 = _S @ np.asarray(K1, np.float64)

    img0 = jnp.asarray(img0, jnp.float32)
    img1 = jnp.asarray(img1, jnp.float32)
    if smooth_sigma > 0:
        from wass_tpu.match.features import _gauss_blur

        img0 = _gauss_blur(img0, smooth_sigma)
        img1 = _gauss_blur(img1, smooth_sigma)

    # AUTO feature budget / NMS density: resolution-scaled on the image
    # actually matched (so heavy-noise half-res matching gets the 1 MP
    # class).
    area_mp = img0.shape[0] * img0.shape[1] / 1e6
    n_feat = cfg.num_features or (2000 if area_mp <= 1.5 else 4000)
    grid_cell = cfg.feature_grid_cell or (12 if area_mp <= 1.5 else 8)

    f0 = detect_features(
        jnp.asarray(img0, jnp.float32),
        max_features=n_feat,
        hessian_threshold=cfg.hessian_threshold,
        grid_cell=grid_cell,
        area_subdivision=cfg.area_subdivision,
    )
    f1 = detect_features(
        jnp.asarray(img1, jnp.float32),
        max_features=n_feat,
        hessian_threshold=cfg.hessian_threshold,
        grid_cell=grid_cell,
        area_subdivision=cfg.area_subdivision,
    )

    cand = generate_candidates(f0, f1, cfg.n_candidates_per_feature, cfg.nndr)
    if cfg.skip_gt:
        result = nearest_match(cand)
    else:
        pay = payoff_matrix(f0, f1, cand, cfg.matcher_lambda)
        result = gt_match(
            f0,
            f1,
            cand,
            pay,
            k_match,
            pop_threshold=cfg.population_threshold,
            max_rounds=cfg.max_rounds,
            min_group_size=cfg.min_group_size,
            iidyn_iters=cfg.iidyn_iters,
        )

    sel = np.asarray(result.valid)
    src = np.asarray(result.src)[sel]
    dst = np.asarray(result.dst)[sel]
    uv0 = np.asarray(f0.xy)[src]
    uv1 = np.asarray(f1.xy)[dst]
    if len(uv0) < 8:
        return None

    if cfg.lk_refine:
        from wass_tpu.match.refine import refine_matches_lk

        lk_win = cfg.lk_win or max(7, round(7 * img0.shape[1] / 1024))
        uv1 = np.asarray(
            refine_matches_lk(
                jnp.asarray(img0, jnp.float32),
                jnp.asarray(img1, jnp.float32),
                jnp.asarray(uv0, jnp.float32),
                jnp.asarray(uv1, jnp.float32),
                win=lk_win,
            )
        )

    # Normalized coordinates for the essential matrix (wass_match.cpp:311-326).
    K0 = np.asarray(K0, np.float64)
    K1 = np.asarray(K1, np.float64)
    K0i = np.linalg.inv(K0)
    K1i = np.linalg.inv(K1)
    focal = 0.5 * (K0[0, 0] + K0[1, 1])
    p0n = (np.c_[uv0, np.ones(len(uv0))] @ K0i.T)[:, :2]
    p1n = (np.c_[uv1, np.ones(len(uv1))] @ K1i.T)[:, :2]

    # Pad to a fixed capacity so RANSAC shapes stay static across frames.
    cap = int(2 ** np.ceil(np.log2(max(len(p0n), 64))))
    pad = cap - len(p0n)
    p0j = jnp.asarray(np.pad(p0n, ((0, pad), (0, 0))), jnp.float32)
    p1j = jnp.asarray(np.pad(p1n, ((0, pad), (0, 0))), jnp.float32)
    vj = jnp.asarray(np.pad(np.ones(len(p0n), bool), (0, pad)))

    rp = relative_pose_ransac(
        p0j, p1j, vj, k_ransac, threshold=cfg.max_epi_distance / focal, n_hypotheses=cfg.ransac_hypotheses
    )

    inl = np.asarray(rp.inliers)[: len(p0n)]
    R = np.asarray(rp.R, np.float64)
    T = np.asarray(rp.T, np.float64)

    # Chirality inliers for matches.txt: reference reuses the RANSAC mask
    # updated by recoverPose; we use the epipolar inliers whose triangulation
    # lands in front of both cameras.
    from wass_tpu.core.triangulate import triangulate_normalized

    pts = np.asarray(triangulate_normalized(p0j, p1j, jnp.asarray(R, jnp.float32), jnp.asarray(T, jnp.float32)))[: len(p0n)]
    front = (pts[:, 2] > 0) & ((pts @ R.T + T)[:, 2] > 0)
    pose_inl = inl & front
    if pose_inl.sum() < 8:
        return None

    # Epipolar error stats on pixel coords with F = K1^-T E K0^-1,
    # computed in HOST f64: the f32 device metric is precision-inflated
    # several-fold at megapixel coordinates (catastrophic cancellation in
    # x1^T F x0 — same failure the calibration solvers hit), which made
    # honest sub-0.5 px matchers report > 2 px averages at 3 MP.
    E = np.asarray(rp.E, np.float64)
    F = K1i.T @ E @ K0i
    x0 = np.c_[uv0[pose_inl].astype(np.float64), np.ones(int(pose_inl.sum()))]
    x1 = np.c_[uv1[pose_inl].astype(np.float64), np.ones(int(pose_inl.sum()))]
    Fx0 = x0 @ F.T
    Ftx1 = x1 @ F
    num = np.abs(np.sum(x1 * Fx0, -1))
    d_sym = 0.5 * (
        num / np.sqrt(Fx0[:, 0] ** 2 + Fx0[:, 1] ** 2 + 1e-300)
        + num / np.sqrt(Ftx1[:, 0] ** 2 + Ftx1[:, 1] ** 2 + 1e-300)
    )

    class stats:  # ErrorStats-shaped host container
        avg = d_sym.mean() if d_sym.size else float("nan")
        std = d_sym.std() if d_sym.size else float("nan")
        min = d_sym.min() if d_sym.size else float("nan")
        max = d_sym.max() if d_sym.size else float("nan")

    if half_res:
        # Map coordinates back to full resolution (inverse of _S above);
        # epipolar distances scale with the pixel grid.
        uv0 = uv0 * 2.0 + 0.5
        uv1 = uv1 * 2.0 + 0.5
        epi_scale = 2.0
    else:
        epi_scale = 1.0

    return MatchStageResult(
        R=R,
        T=T.reshape(3, 1),
        uv0_all=uv0,
        uv1_all=uv1,
        uv0_epi=uv0[inl],
        uv1_epi=uv1[inl],
        uv0_pose=uv0[pose_inl],
        uv1_pose=uv1[pose_inl],
        epi_avg=float(stats.avg) * epi_scale,
        epi_std=float(stats.std) * epi_scale,
        epi_min=float(stats.min) * epi_scale,
        epi_max=float(stats.max) * epi_scale,
        n_matches=int(pose_inl.sum()),
    )
