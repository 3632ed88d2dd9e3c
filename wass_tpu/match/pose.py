"""Planar-degeneracy-robust relative pose estimation.

The reference estimates E with cv::findEssentialMat's Nister 5-point
solver (wass_match.cpp:280, wass_autocalibrate.cpp:177).  A sea surface is
*quasi-planar*, which makes the 8-point algorithm degenerate (the
epipolar constraint is satisfied by a 2-parameter family when all points
lie on a plane) — the very situation 5-point tolerates.  The 5-point
action-matrix eigendecomposition needs a nonsymmetric eig, which XLA does
not batch well on an accelerator,
so this module uses a domain-aware equivalent:

* hypotheses are 4-point homographies (the correct minimal model for a
  plane), decomposed analytically into their two (R, t, n) solutions
  (Faugeras-Lustman / "Invitation to 3D Vision" Thm 5.19) -> 4 pose
  candidates each, plus plain 8-point hypotheses for parallax-rich scenes;
* all candidates are scored uniformly by Sampson-inlier count of
  E = [t]x R;
* the winner is polished by a few Gauss-Newton steps on the robust
  Sampson cost over all matches (5-DOF: so(3) x tangent-of-sphere).

Everything is batched: hypothesis generation/decomposition is a vmapped
SVD, scoring is a (hypotheses x matches) broadcast, refinement is a tiny
jacfwd + 5x5 solve.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from wass_tpu.core.epipolar import sampson_distance
from wass_tpu.core.geometry import rodrigues, skew


class RelPoseResult(NamedTuple):
    R: jnp.ndarray
    T: jnp.ndarray  # unit norm
    E: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def _homography_dlt(p0: jnp.ndarray, p1: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted DLT homography from normalized correspondences (N >= 4)."""
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    z = jnp.zeros_like(x0)
    o = jnp.ones_like(x0)
    r1 = jnp.stack([x0, y0, o, z, z, z, -x1 * x0, -x1 * y0, -x1], -1)
    r2 = jnp.stack([z, z, z, x0, y0, o, -y1 * x0, -y1 * y0, -y1], -1)
    A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)
    M = A.T @ A
    _, V = jnp.linalg.eigh(M)
    return V[:, 0].reshape(3, 3)


def _decompose_homography(H: jnp.ndarray):
    """Calibrated H -> 4 candidate (R, t) pairs (t unnormalized).

    H is first scaled so its middle singular value is 1 and sign-fixed so
    that depths come out positive for points in front.
    """
    U, S, Vt = jnp.linalg.svd(H)
    Hn = H / S[1]
    s1 = S[0] / S[1]
    s3 = S[2] / S[1]

    V = Vt.T
    v1 = V[:, 0]
    v2 = V[:, 1]
    v3 = V[:, 2]

    denom = jnp.sqrt(jnp.maximum(s1 * s1 - s3 * s3, 1e-12))
    a = jnp.sqrt(jnp.maximum(1.0 - s3 * s3, 0.0))
    b = jnp.sqrt(jnp.maximum(s1 * s1 - 1.0, 0.0))
    u1 = (a * v1 + b * v3) / denom
    u2 = (a * v1 - b * v3) / denom

    def solution(u):
        U1 = jnp.stack([v2, u, jnp.cross(v2, u)], axis=1)
        W1 = jnp.stack([Hn @ v2, Hn @ u, jnp.cross(Hn @ v2, Hn @ u)], axis=1)
        R = W1 @ U1.T
        n = jnp.cross(v2, u)
        t = (Hn - R) @ n
        return R, t

    Ra, ta = solution(u1)
    Rb, tb = solution(u2)
    Rs = jnp.stack([Ra, Ra, Rb, Rb])
    ts = jnp.stack([ta, -ta, tb, -tb])
    return Rs, ts


def _pose_to_E(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    return skew(t) @ R


def _eight_point_E(p0, p1, w):
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    o = jnp.ones_like(x0)
    A = jnp.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, o], -1) * w[:, None]
    M = A.T @ A
    _, V = jnp.linalg.eigh(M)
    E = V[:, 0].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(E)
    s = (S[0] + S[1]) / 2
    return U @ jnp.diag(jnp.array([s, s, 0.0], E.dtype)) @ Vt


def _tangent_basis(t: jnp.ndarray):
    """Two orthonormal vectors spanning the tangent space of the unit
    sphere at t (branch-free)."""
    ref = jnp.where(jnp.abs(t[0]) < 0.9, jnp.array([1.0, 0.0, 0.0], t.dtype), jnp.array([0.0, 1.0, 0.0], t.dtype))
    b1 = jnp.cross(t, ref)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
    b2 = jnp.cross(t, b1)
    return b1, b2


def relative_pose_ransac(*args, **kwargs) -> "RelPoseResult":
    """RANSAC + GN relative pose (see _relative_pose_ransac_jit).

    Forces full-f32 matmul precision: reduced-precision f32 products
    (TF32 on a GPU) cost recovered pose accuracy on this
    calibration-critical path; the matrices here are tiny, so "highest"
    is free.
    """
    with jax.default_matmul_precision("highest"):
        return _relative_pose_ransac_jit(*args, **kwargs)


@partial(jax.jit, static_argnames=("n_hypotheses", "gn_iters"))
def _relative_pose_ransac_jit(
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    threshold: float,
    n_hypotheses: int = 512,
    gn_iters: int = 10,
) -> RelPoseResult:
    """RANSAC + GN relative pose from normalized correspondences.

    threshold: Sampson distance bound in normalized units (px / focal).
    """
    N = p0.shape[0]
    t2 = threshold * threshold
    k_h, k_e = jax.random.split(key)

    from wass_tpu.match.ransac import decompose_essential
    from wass_tpu.core.triangulate import triangulate_normalized

    def pose_score(R, t):
        """Chirality-aware inlier count: Sampson inlier AND triangulates in
        front of both cameras.  This resolves the planar two-fold
        (Faugeras mirror) ambiguity that a pure epipolar score cannot see.
        """
        E = _pose_to_E(R, t)
        d = sampson_distance(E, p0, p1)
        pts = triangulate_normalized(p0, p1, R, t)
        z1 = pts @ R[2] + t[2]
        return jnp.sum((d < t2) & (pts[:, 2] > 0) & (z1 > 0) & valid)

    # --- homography hypotheses (4 pose candidates each) --------------------
    keysH = jax.random.split(k_h, n_hypotheses)

    def h_hypo(k):
        idx = jax.random.randint(k, (4,), 0, N)
        ok = jnp.all(valid[idx])
        H = _homography_dlt(p0[idx], p1[idx], jnp.ones(4, p0.dtype))
        # Sign fix: p1 ~ H p0 with positive scale for the sample points.
        ph = jnp.concatenate([p0[idx], jnp.ones((4, 1), p0.dtype)], -1) @ H.T
        sgn = jnp.sign(jnp.sum(ph[:, 2]))
        H = H * jnp.where(sgn == 0, 1.0, sgn)
        Rs, ts = _decompose_homography(H)
        sc = jax.vmap(pose_score)(Rs, ts)
        sc = jnp.where(ok, sc, -1)
        return sc, Rs, ts

    scH, RH, tH = jax.vmap(h_hypo)(keysH)  # (nh, 4), (nh, 4, 3, 3), (nh, 4, 3)

    # --- 8-point hypotheses (4 chirality alternatives each) ----------------
    keysE = jax.random.split(k_e, n_hypotheses // 4)

    def e_hypo(k):
        idx = jax.random.randint(k, (8,), 0, N)
        ok = jnp.all(valid[idx])
        E = _eight_point_E(p0[idx], p1[idx], jnp.ones(8, p0.dtype))
        R1, R2, te = decompose_essential(E)
        Rs = jnp.stack([R1, R1, R2, R2])
        ts = jnp.stack([te, -te, te, -te])
        sc = jax.vmap(pose_score)(Rs, ts)
        return jnp.where(ok, sc, -1), Rs, ts

    scE, RE, tE = jax.vmap(e_hypo)(keysE)

    # --- pick the best candidate over both families ------------------------
    flatH = scH.reshape(-1)
    flatE = scE.reshape(-1)
    bestH = jnp.argmax(flatH)
    bestE8 = jnp.argmax(flatE)
    use_h = flatH[bestH] >= flatE[bestE8]

    R_h = RH.reshape(-1, 3, 3)[bestH]
    t_h = tH.reshape(-1, 3)[bestH]
    R_e = RE.reshape(-1, 3, 3)[bestE8]
    t_e = tE.reshape(-1, 3)[bestE8]

    R0 = jnp.where(use_h, R_h, R_e)
    t0 = jnp.where(use_h, t_h, t_e)
    t0 = t0 / jnp.maximum(jnp.linalg.norm(t0), 1e-12)

    # --- Gauss-Newton polish on robust Sampson cost ------------------------
    def residuals(params, R_base, t_base):
        dw = params[:3]
        dt = params[3:]
        R = rodrigues(dw) @ R_base
        b1, b2 = _tangent_basis(t_base)
        t = t_base + dt[0] * b1 + dt[1] * b2
        t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
        E = skew(t) @ R
        d2 = sampson_distance(E, p0, p1)
        d = jnp.sqrt(jnp.maximum(d2, 1e-24))
        # Huber weights at the inlier threshold.
        wgt = jnp.where(d < threshold, 1.0, threshold / d) * valid
        return d * wgt

    def gn_step(carry, _):
        R_base, t_base = carry
        p = jnp.zeros(5, p0.dtype)
        J = jax.jacfwd(residuals)(p, R_base, t_base)  # (N, 5)
        r = residuals(p, R_base, t_base)
        JtJ = J.T @ J + 1e-8 * jnp.eye(5, dtype=p0.dtype)
        g = J.T @ r
        dp = -jnp.linalg.solve(JtJ, g)
        R_new = rodrigues(dp[:3]) @ R_base
        b1, b2 = _tangent_basis(t_base)
        t_new = t_base + dp[3] * b1 + dp[4] * b2
        t_new = t_new / jnp.maximum(jnp.linalg.norm(t_new), 1e-12)
        # Keep the step only if the chirality-aware inlier count holds.
        better = pose_score(R_new, t_new) >= pose_score(R_base, t_base)
        R_out = jnp.where(better, R_new, R_base)
        t_out = jnp.where(better, t_new, t_base)
        return (R_out, t_out), None

    (R_f, t_f), _ = jax.lax.scan(gn_step, (R0, t0), None, length=gn_iters)

    E_f = skew(t_f) @ R_f
    d = sampson_distance(E_f, p0, p1)
    inl = (d < t2) & valid
    return RelPoseResult(R=R_f, T=t_f, E=E_f, inliers=inl, n_inliers=jnp.sum(inl))
