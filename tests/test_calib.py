"""Autocalibration tests: LM bundle adjustment and the sequence reduction,
against the reference's acceptance gates
(/root/reference/test/verify_matcher.m:7-8: max|dT| <= 2e-2, max|dR| <= 5e-3)."""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wass_tpu.calib.ba import lm_refine_two_view
from wass_tpu.calib.autocalibrate import autocalibrate_pooled, AutocalConfig
from wass_tpu.match.pose import relative_pose_ransac


def make_two_view(rng, n=600, noise=2e-4, planar=False):
    R, _ = cv2.Rodrigues(np.array([0.02, -0.25, 0.015]))
    T = np.array([-1.0, 0.02, 0.06])
    T = T / np.linalg.norm(T)
    if planar:
        # Quasi-planar scene (sea surface): z = a x + b y + c + ripple.
        x = rng.uniform(-4, 4, n)
        y = rng.uniform(-4, 4, n)
        z = 12 + 0.5 * x - 0.8 * y + rng.standard_normal(n) * 0.1
        pts = np.stack([x, y, z], 1)
    else:
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(8, 25, n)], 1)
    p0 = pts[:, :2] / pts[:, 2:]
    x1 = pts @ R.T + T
    p1 = x1[:, :2] / x1[:, 2:]
    p0 = p0 + rng.standard_normal(p0.shape) * noise
    p1 = p1 + rng.standard_normal(p1.shape) * noise
    return R, T, pts, p0, p1


class TestBA:
    def test_lm_converges(self, rng):
        R, T, pts, p0, p1 = make_two_view(rng)
        Rp, _ = cv2.Rodrigues(cv2.Rodrigues(R)[0].ravel() + np.array([2e-3, -1.5e-3, 1e-3]))
        Tp = T + np.array([3e-3, -2e-3, 1e-3])
        Xp = pts + rng.standard_normal(pts.shape) * 0.05
        mask = np.ones(len(pts), bool)
        res = lm_refine_two_view(
            jnp.asarray(Rp, jnp.float32), jnp.asarray(Tp, jnp.float32), jnp.asarray(Xp, jnp.float32),
            jnp.asarray(p0, jnp.float32), jnp.asarray(p1, jnp.float32), jnp.asarray(mask),
        )
        assert float(res.final_cost) < float(res.initial_cost) * 0.05
        Tr = np.array(res.T)
        Tr = Tr / np.linalg.norm(Tr)
        assert np.abs(np.array(res.R) - R).max() < 5e-4
        assert np.abs(Tr - T).max() < 2e-3

    def test_mask_excludes_padding(self, rng):
        R, T, pts, p0, p1 = make_two_view(rng, n=128)
        # Garbage in padded slots must not affect the result.
        pad = 64
        p0p = np.concatenate([p0, rng.standard_normal((pad, 2)) * 10])
        p1p = np.concatenate([p1, rng.standard_normal((pad, 2)) * 10])
        Xp = np.concatenate([pts, np.ones((pad, 3))])
        mask = np.concatenate([np.ones(len(pts), bool), np.zeros(pad, bool)])
        res = lm_refine_two_view(
            jnp.asarray(R, jnp.float32), jnp.asarray(T, jnp.float32), jnp.asarray(Xp, jnp.float32),
            jnp.asarray(p0p, jnp.float32), jnp.asarray(p1p, jnp.float32), jnp.asarray(mask),
        )
        assert np.abs(np.array(res.R) - R).max() < 1e-3


class TestPlanarPose:
    def test_pose_on_planar_scene(self, rng):
        """The 8-point-degenerate case the homography path must handle."""
        R, T, pts, p0, p1 = make_two_view(rng, planar=True, noise=3e-4)
        out = rng.random(len(p0)) < 0.2
        p1[out] = rng.uniform(-0.4, 0.4, (out.sum(), 2))
        rp = relative_pose_ransac(
            jnp.asarray(p0, jnp.float32), jnp.asarray(p1, jnp.float32),
            jnp.ones(len(p0), bool), jax.random.PRNGKey(2), threshold=1.5 / 1000.0,
        )
        assert int(rp.n_inliers) > 0.6 * len(p0)
        assert np.abs(np.array(rp.R) - R).max() < 5e-3
        assert np.abs(np.array(rp.T) - T).max() < 2e-2


class TestAutocalibrate:
    def test_pooled_reduction_meets_gates(self, rng):
        """Pool noisy pixel matches from several 'frames', recover extrinsics
        within the verify_matcher gates."""
        K = np.array([[1400.0, 0, 1024], [0, 1400, 768], [0, 0, 1]])
        R, T, pts, p0n, p1n = make_two_view(rng, n=3000, noise=0.4 / 1400, planar=True)
        uv0 = p0n * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        uv1 = p1n * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        res = autocalibrate_pooled(uv0, uv1, K, K, AutocalConfig(max_points=4096))
        assert res is not None
        assert np.abs(res.R - R).max() < 5e-3
        assert np.abs(res.T.ravel() - T).max() < 2e-2
        # BA must not degrade the RANSAC+GN initialization (f32 jitter slack).
        assert res.epi_med_after <= res.epi_med_before + 1e-4

    def test_f64_polish_beats_f32_floor(self, rng):
        """The final host polish (polish_pose_f64) must recover rotation
        below the f32 device-polish floor (~1e-4 rad) when match noise
        sits at the LK-refined level (~3e-6 normalized, quality.md)."""
        from wass_tpu.calib.ba import polish_pose_f64

        R, T, pts, p0, p1 = make_two_view(rng, n=2000, noise=3e-6)
        dR, _ = cv2.Rodrigues(np.array([4e-4, -3e-4, 2e-4]))
        R0 = dR @ R
        T0 = T + np.array([1e-3, -8e-4, 5e-4])
        T0 = T0 / np.linalg.norm(T0)
        Rr, Tr, rms0, rms1 = polish_pose_f64(R0, T0, p0, p1, np.ones(len(p0)))
        assert rms1 <= rms0
        assert np.abs(Rr - R).max() < 3e-5        # 20x under the f32 floor
        assert np.abs(Tr - T).max() < 3e-4

    def test_pooled_reduction_f64_precision(self, rng):
        """End-to-end pooled reduction at realistic pooled-inlier counts and
        the LK noise floor: dR must land well under the ~6e-4 residual the
        f32-only polish measured."""
        K = np.array([[1400.0, 0, 1024], [0, 1400, 768], [0, 0, 1]])
        R, T, pts, p0n, p1n = make_two_view(rng, n=2500, noise=0.01 / 1400, planar=True)
        # Contaminating tail like the production pool (few-% gross mismatches).
        out = rng.random(len(p0n)) < 0.03
        p1n[out] += rng.uniform(-0.02, 0.02, (int(out.sum()), 2))
        uv0 = p0n * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        uv1 = p1n * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        res = autocalibrate_pooled(uv0, uv1, K, K, AutocalConfig(max_points=4096))
        assert res is not None
        assert np.abs(res.R - R).max() < 1e-4
        assert np.abs(res.T.ravel() - T).max() < 1e-3
