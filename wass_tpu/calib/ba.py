"""Two-view sparse bundle adjustment: autodiff LM with a Schur complement.

Replaces the reference's libsba + Maple-generated analytic Jacobians
(sba_driver, /root/reference/src/wass_autocalibrate/sba_driver.cpp:281-643,
sba_motstr_levmar_x call :773-777) with a batched, fixed-shape design:

* camera 0 is gauge-fixed at the identity; the free parameters are camera
  1's local rotation increment (so(3)) + translation, plus the 3D points;
* per-point residuals/Jacobians come from jax.jacfwd, vmapped over the
  point batch — no hand-derived Jacobians;
* the normal equations are solved by the standard motion/structure Schur
  complement: point blocks are batched closed-form 3x3 inverses, the
  reduced 6x6 camera system is dense;
* the LM loop is a lax.while_loop with multiplicative damping.

The structure reductions (H_cc, H_cp-weighted accumulations) are plain
masked sums over the point axis — on a multi-host mesh the same code runs
point-sharded with a jax.lax.psum over those sums (see
wass_tpu/parallel/distba.py), which is the "distributed Schur-complement
BA" of BASELINE.json.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from wass_tpu.core.geometry import rodrigues, solve3x3


class BAResult(NamedTuple):
    R: jnp.ndarray  # (3, 3) refined cam0->cam1 rotation
    T: jnp.ndarray  # (3,) refined translation (NOT renormalized)
    X: jnp.ndarray  # (N, 3) refined points
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    n_iters: jnp.ndarray


def _point_residual(cam: jnp.ndarray, R0: jnp.ndarray, X: jnp.ndarray, p0: jnp.ndarray, p1: jnp.ndarray):
    """Residual (4,) of one point observed in both cameras.

    cam = (w[3], T[3]): R = rodrigues(w) @ R0.  Normalized image coords.
    """
    w = cam[:3]
    T = cam[3:]
    R = rodrigues(w) @ R0
    r0 = X[:2] / X[2] - p0
    X1 = R @ X + T
    r1 = X1[:2] / X1[2] - p1
    return jnp.concatenate([r0, r1])


def lm_refine_two_view(*args, **kwargs) -> "BAResult":
    """Two-view LM BA (see _lm_refine_two_view_jit); forces full-f32
    matmul precision — reduced-precision f32 products (TF32 on a GPU) cost
    this calibration-critical path pose accuracy, and the per-iteration
    matrices are tiny."""
    with jax.default_matmul_precision("highest"):
        return _lm_refine_two_view_jit(*args, **kwargs)


@partial(jax.jit, static_argnames=("max_iters", "axis_name"))
def _lm_refine_two_view_jit(
    R_init: jnp.ndarray,
    T_init: jnp.ndarray,
    X_init: jnp.ndarray,
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    mask: jnp.ndarray,
    max_iters: int = 50,
    lam0: float = 1e-3,
    axis_name: str | None = None,
) -> BAResult:
    """LM refinement of (R, T, X) minimizing masked reprojection error.

    Args:
      R_init, T_init: initial cam0->cam1 extrinsics.
      X_init: (N, 3) initial points (cam0 frame).
      p0, p1: (N, 2) normalized observations.
      mask: (N,) bool; padded slots are False.
      axis_name: when set, per-point arrays are assumed sharded along a
        mesh axis of that name (running under shard_map): the camera-block
        reductions (A, g_c, the Schur complement and the cost) are psum-ed
        across shards while every point block stays local — the
        distributed Schur-complement BA of BASELINE.json.
    """
    N = X_init.shape[0]
    m = mask.astype(jnp.float32)

    jac = jax.vmap(jax.jacfwd(_point_residual, argnums=(0, 2)), in_axes=(None, None, 0, 0, 0))
    res_fn = jax.vmap(_point_residual, in_axes=(None, None, 0, 0, 0))

    def _allreduce(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def cost(cam, R0, X):
        r = res_fn(cam, R0, X, p0, p1)
        return _allreduce(jnp.sum(r * r * m[:, None]))

    def lm_step(state):
        cam, R0, X, lam, it, c_prev, done = state
        r = res_fn(cam, R0, X, p0, p1)  # (N, 4)
        Jc, Jp = jac(cam, R0, X, p0, p1)  # (N, 4, 6), (N, 4, 3)
        w = m[:, None, None]
        JcT = jnp.swapaxes(Jc, 1, 2) * jnp.swapaxes(w, 1, 2)

        # Blocks of the normal equations.
        Jp_w = Jp * w
        A = jnp.einsum("nik,nkj->ij", JcT, Jc)  # (6, 6)
        B = jnp.einsum("nik,nkj->nij", JcT, Jp)  # (N, 6, 3)
        C = jnp.einsum("nki,nkj->nij", Jp_w, Jp)  # (N, 3, 3)
        g_c = -jnp.einsum("nik,nk->i", JcT, r)
        g_p = -jnp.einsum("nki,nk->ni", Jp_w, r)

        # Damping.
        A_d = A + lam * jnp.diag(jnp.diag(A) + 1e-12)
        C_d = C + lam * (C * jnp.eye(3) + 1e-12 * jnp.eye(3))

        # Invert point blocks in closed form (batched).
        Ci = jnp.linalg.inv(C_d + (1.0 - m)[:, None, None] * jnp.eye(3))
        Ci = Ci * m[:, None, None]

        # Schur complement onto the camera block.
        BCi = jnp.einsum("nij,njk->nik", B, Ci)
        S = _allreduce(A_d - jnp.einsum("nik,njk->ij", BCi, B))
        rhs = _allreduce(g_c - jnp.einsum("nik,nk->i", BCi, g_p))
        dc = jnp.linalg.solve(S, rhs)
        dX = jnp.einsum("nij,nj->ni", Ci, g_p - jnp.einsum("nji,j->ni", B, dc))

        cam_new = cam + dc
        X_new = X + dX
        c_new = cost(cam_new, R0, X_new)
        accept = c_new < c_prev
        cam = jnp.where(accept, cam_new, cam)
        X = jnp.where(accept, X_new, X)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-9), jnp.minimum(lam * 5.0, 1e6))
        c_next = jnp.where(accept, c_new, c_prev)
        rel = jnp.abs(c_prev - c_next) / jnp.maximum(c_prev, 1e-20)
        done = (~accept & (lam >= 1e6)) | (accept & (rel < 1e-10))
        return cam, R0, X, lam, it + 1, c_next, done

    def cond(state):
        _, _, _, _, it, _, done = state
        return (it < max_iters) & ~done

    cam0 = jnp.concatenate([jnp.zeros(3, X_init.dtype), T_init.reshape(3)])
    c0 = cost(cam0, R_init, X_init)
    state = (cam0, R_init, X_init, jnp.asarray(lam0, X_init.dtype), jnp.int32(0), c0, False)
    cam, R0, X, lam, it, c_final, _ = jax.lax.while_loop(cond, lm_step, state)

    R = rodrigues(cam[:3]) @ R0
    return BAResult(R=R, T=cam[3:], X=X, initial_cost=c0, final_cost=c_final, n_iters=it)


# --------------------------------------------------------------------------
# Epipolar (Sampson) pose polish
# --------------------------------------------------------------------------


def _tangent_basis(T: jnp.ndarray) -> jnp.ndarray:
    """(3, 2) orthonormal basis of the plane perpendicular to unit T."""
    a = jnp.where(jnp.abs(T[0]) < 0.9, jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    b1 = jnp.cross(T, a)
    b1 = b1 / jnp.linalg.norm(b1)
    b2 = jnp.cross(T, b1)
    return jnp.stack([b1, b2], axis=-1)


class EpipolarPolishResult(NamedTuple):
    R: jnp.ndarray
    T: jnp.ndarray  # unit norm
    initial_rms: jnp.ndarray  # masked Sampson RMS (normalized coords)
    final_rms: jnp.ndarray


def lm_refine_pose_epipolar(*args, **kwargs) -> "EpipolarPolishResult":
    """Sampson pose polish (see _lm_refine_pose_epipolar_jit); forced
    full-f32 matmul precision like the other calibration solvers."""
    with jax.default_matmul_precision("highest"):
        return _lm_refine_pose_epipolar_jit(*args, **kwargs)


@partial(jax.jit, static_argnames=("max_iters",))
def _lm_refine_pose_epipolar_jit(
    R_init: jnp.ndarray,
    T_init: jnp.ndarray,
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    mask: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    max_iters: int = 60,
    robust_scale: float | None = None,
) -> EpipolarPolishResult:
    """Minimal 5-dof pose polish minimizing the (optionally weighted)
    Sampson epipolar distance over ALL masked correspondences (normalized
    image coords).

    Complements lm_refine_two_view (reprojection BA over a subsampled,
    triangulated point set): the Sampson objective needs no 3D points, so
    every pooled inlier constrains the pose — the estimator the reference's
    full-sequence sba effectively realizes with thousands of observations
    (/root/reference/src/wass_autocalibrate/sba_driver.cpp).  Parameters:
    rotation tangent w (3) with R = rodrigues(w) @ R0 and a 2-dof in-plane
    translation update T = normalize(T0 + B t) on the unit sphere.

    weights: per-match robust weights (IRLS outer loop lives in the
    caller, e.g. the Cauchy-annealed polish in autocalibrate_pooled)."""
    from wass_tpu.core.geometry import skew

    T0 = T_init.reshape(3) / jnp.linalg.norm(T_init)
    B = _tangent_basis(T0)
    x0 = jnp.concatenate([p0, jnp.ones_like(p0[:, :1])], axis=-1)
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=-1)
    m = mask.astype(p0.dtype)
    if weights is not None:
        m = m * jnp.sqrt(jnp.maximum(weights.astype(p0.dtype), 0.0))
    n_eff = jnp.maximum(jnp.sum(m * m), 1.0)

    def residual(theta):
        R = rodrigues(theta[:3]) @ R_init
        T = T0 + B @ theta[3:]
        T = T / jnp.linalg.norm(T)
        E = skew(T) @ R
        Ex0 = x0 @ E.T
        Etx1 = x1 @ E
        num = jnp.sum(x1 * Ex0, axis=-1)
        den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
        r = num / jnp.sqrt(den + 1e-18)
        if robust_scale is not None:
            # Redescending M-estimator (Geman-McClure style): r~ saturates
            # at the scale c, so a gross outlier's influence vanishes
            # *inside* the optimization — unlike externally-reweighted
            # IRLS, whose one-step-stale weights let the pose drift to a
            # degenerate epipole-in-cloud optimum (observed: median px
            # distance 8 -> 58 over annealed rounds while the weighted
            # rms fell).  The transform keeps consistent units with the
            # residual it bounds.
            c = jnp.asarray(robust_scale, p0.dtype)
            r = r / jnp.sqrt(1.0 + jnp.square(r / c))
        return m * r

    def cost(theta):
        r = residual(theta)
        return jnp.sum(r * r)

    jac = jax.jacfwd(residual)

    def lm_step(state):
        theta, lam, it, c_prev, done = state
        J = jac(theta)  # (N, 5)
        r = residual(theta)
        H = J.T @ J
        g = J.T @ r
        Hd = H + lam * jnp.diag(jnp.diag(H) + 1e-12)
        dtheta = jnp.linalg.solve(Hd, g)
        theta_new = theta - dtheta
        c_new = cost(theta_new)
        accept = c_new < c_prev
        theta = jnp.where(accept, theta_new, theta)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-10), jnp.minimum(lam * 5.0, 1e8))
        c_next = jnp.where(accept, c_new, c_prev)
        rel = jnp.abs(c_prev - c_next) / jnp.maximum(c_prev, 1e-20)
        done = (~accept & (lam >= 1e8)) | (accept & (rel < 1e-12))
        return theta, lam, it + 1, c_next, done

    def cond(state):
        _, _, it, _, done = state
        return (it < max_iters) & ~done

    theta0 = jnp.zeros(5, p0.dtype)
    c0 = cost(theta0)
    theta, _, _, c_final, _ = jax.lax.while_loop(
        cond, lm_step, (theta0, jnp.asarray(1e-3, p0.dtype), jnp.int32(0), c0, False)
    )
    R = rodrigues(theta[:3]) @ R_init
    T = T0 + B @ theta[3:]
    T = T / jnp.linalg.norm(T)
    return EpipolarPolishResult(
        R=R, T=T,
        initial_rms=jnp.sqrt(c0 / n_eff),
        final_rms=jnp.sqrt(c_final / n_eff),
    )


# --------------------------------------------------------------------------
# Final float64 host polish
# --------------------------------------------------------------------------


def polish_pose_f64(R_init, T_init, p0, p1, weights, max_iters=60):
    """Host float64 LM Sampson polish (5 dof) over fixed-weight matches.

    The on-device polish above runs in float32: a genuine LK-refined
    match has a normalized Sampson residual of ~3e-6 at f~1.5e3 px,
    right at f32 resolution around unit-scale image coordinates, which
    floors the recoverable rotation error near 1e-4 rad.  This numpy
    float64 pass (numeric central-difference Jacobian over the 5-dof
    tangent, O(N) per iteration, N ~ thousands) removes that floor.
    The reference counterpart runs in double throughout
    (/root/reference/src/wass_autocalibrate/sba_driver.cpp).

    Returns (R, T_unit, rms_before, rms_after) in float64; the weighted
    cost is monotone non-increasing so the result never regresses.
    """
    import numpy as np

    R0 = np.asarray(R_init, np.float64)
    T0 = np.asarray(T_init, np.float64).reshape(3)
    T0 = T0 / np.linalg.norm(T0)
    a = np.array([1.0, 0, 0]) if abs(T0[0]) < 0.9 else np.array([0, 1.0, 0])
    b1 = np.cross(T0, a); b1 /= np.linalg.norm(b1)
    B = np.stack([b1, np.cross(T0, b1)], axis=-1)  # (3, 2)

    x0 = np.concatenate([np.asarray(p0, np.float64), np.ones((len(p0), 1))], -1)
    x1 = np.concatenate([np.asarray(p1, np.float64), np.ones((len(p1), 1))], -1)
    sw = np.sqrt(np.maximum(np.asarray(weights, np.float64), 0.0))
    n_eff = max(float((sw ** 2).sum()), 1.0)

    def rodr(w):
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        if th < 1e-12:
            return np.eye(3) + K
        K /= th
        return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)

    def residual(theta):
        R = rodr(theta[:3]) @ R0
        T = T0 + B @ theta[3:]
        T = T / np.linalg.norm(T)
        E = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]]) @ R
        Ex0 = x0 @ E.T
        Etx1 = x1 @ E
        num = np.sum(x1 * Ex0, -1)
        den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
        return sw * num / np.sqrt(den + 1e-300)

    def cost(theta):
        r = residual(theta)
        return float(r @ r)

    theta = np.zeros(5)
    lam = 1e-6
    c_prev = c0 = cost(theta)
    h = 1e-7
    for _ in range(max_iters):
        J = np.empty((len(x0), 5))
        for k in range(5):
            e = np.zeros(5); e[k] = h
            J[:, k] = (residual(theta + e) - residual(theta - e)) / (2 * h)
        r = residual(theta)
        Hm = J.T @ J
        g = J.T @ r
        ok = False
        for _ in range(8):
            try:
                dtheta = np.linalg.solve(Hm + lam * np.diag(np.diag(Hm) + 1e-300), g)
            except np.linalg.LinAlgError:
                lam *= 10; continue
            c_new = cost(theta - dtheta)
            if c_new < c_prev:
                theta = theta - dtheta
                lam = max(lam * 0.3, 1e-12)
                rel = (c_prev - c_new) / max(c_prev, 1e-300)
                c_prev = c_new
                ok = True
                break
            lam = min(lam * 5.0, 1e10)
        if not ok or rel < 1e-14:
            break

    R = rodr(theta[:3]) @ R0
    T = T0 + B @ theta[3:]
    T = T / np.linalg.norm(T)
    return R, T, np.sqrt(c0 / n_eff), np.sqrt(c_prev / n_eff)
