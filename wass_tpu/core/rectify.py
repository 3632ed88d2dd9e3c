"""Stereo rectification: epipole-aligned homographies + Bouguet-style path.

Re-derivation of the reference's two rectification routes:

* the WASS custom method (stereoRectifyUndistorted,
  /root/reference/src/wass_stereo/stereorectify.cpp:57-244): build a
  rectifying rotation whose x-axis is the baseline, optimize one extra
  rotation angle around the baseline so the pair of homographies is "as
  affine as possible" (minimal projective z-row), then scale/translate both
  homographies to a common output frame and compute a shared ROI;

* the cv::stereoRectify (Bouguet) route (wass_stereo.cpp:530-610): rotate
  both cameras by the half-rotation, align the x-axis with the baseline,
  and emit rotation+new-projection pairs.

Design split: these functions are *host-side float64 numpy* — they
run once per frame, need double precision, and produce a handful of 3x3
matrices; the expensive part (warping megapixel images) happens on device
via wass_tpu.ops.sampling.warp_homography with static shapes.  The scalar
angle optimization is a deterministic dense grid search + golden-section
refine instead of a downhill-simplex (same functional, stateless).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class RectifyResult(NamedTuple):
    HL: np.ndarray  # (3,3) homography: left image -> rectified left
    HR: np.ndarray  # (3,3) homography: right image -> rectified right
    roi: Tuple[int, int, int, int]  # (x, y, w, h) common ROI in rectified frame
    angle_deg: float


def _rect_plane_rotation(ep1: np.ndarray) -> np.ndarray:
    """Rotation with rows (baseline, baseline x n, n), n = baseline x e_y."""
    Rv = ep1 / np.linalg.norm(ep1)
    N = np.cross(Rv, np.array([0.0, 1.0, 0.0]))
    N = N / np.linalg.norm(N)
    Rk = np.cross(Rv, N)
    return np.stack([Rv, Rk, N])


def _homographies_for_angle(
    angle_deg: float, Rplane: np.ndarray, K0i: np.ndarray, K1i: np.ndarray, Ri: np.ndarray
):
    """The reference's HFunctional::calc (stereorectify.cpp:91-111)."""
    # Rodrigues of (angle, 0, 0): rotation by angle (in the ref's deg/180*3.14
    # pseudo-radians) around the x-axis of the rectified frame.
    a = angle_deg / 180.0 * 3.14
    ca, sa = np.cos(a), np.sin(a)
    Radd = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    H0 = Radd @ Rplane @ K0i
    H1 = Radd @ Rplane @ Ri @ K1i
    H0 = H0 / H0[2, 2]
    H1 = H1 / H1[2, 2]
    v = max(H0[2, 0] ** 2 + H0[2, 1] ** 2, H1[2, 0] ** 2 + H1[2, 1] ** 2)
    H0 = H0 / np.cbrt(np.linalg.det(H0))
    H1 = H1 / np.cbrt(np.linalg.det(H1))
    return v, H0, H1


def _optimize_angle(Rplane, K0i, K1i, Ri) -> float:
    """Deterministic 1-D minimization of the projective-distortion functional:
    coarse grid over +-60 deg then golden-section refinement."""
    grid = np.linspace(-60.0, 60.0, 481)
    vals = [
        _homographies_for_angle(a, Rplane, K0i, K1i, Ri)[0] for a in grid
    ]
    i = int(np.argmin(vals))
    lo = grid[max(i - 1, 0)]
    hi = grid[min(i + 1, len(grid) - 1)]
    gr = (np.sqrt(5.0) - 1) / 2
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    fc = _homographies_for_angle(c, Rplane, K0i, K1i, Ri)[0]
    fd = _homographies_for_angle(d, Rplane, K0i, K1i, Ri)[0]
    for _ in range(60):
        if fc < fd:
            hi, d, fd = d, c, fc
            c = hi - gr * (hi - lo)
            fc = _homographies_for_angle(c, Rplane, K0i, K1i, Ri)[0]
        else:
            lo, c, fc = c, d, fd
            d = lo + gr * (hi - lo)
            fd = _homographies_for_angle(d, Rplane, K0i, K1i, Ri)[0]
    return float(0.5 * (lo + hi))


def _corners(w: int, h: int) -> np.ndarray:
    return np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], dtype=np.float64).T


def _project(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    q = H @ pts
    return q[:2] / q[2]


def stereo_rectify_homographies(
    K0: np.ndarray,
    K1: np.ndarray,
    Rinv: np.ndarray,
    Tinv: np.ndarray,
    image_size: Tuple[int, int],
    out_size: Optional[Tuple[int, int]] = None,
    angle_deg: float = 0.0,
) -> RectifyResult:
    """WASS custom rectification (stereorectify.cpp:57-244).

    Args:
      K0, K1: intrinsics of left/right cameras.
      Rinv, Tinv: inverse extrinsics (x_left = Rinv x_right + Tinv); Tinv is
        the right-camera center in the left frame, i.e. the epipole direction.
      image_size: (width, height) of the input images.
      out_size: (width, height) of the rectified output (default: input size).
      angle_deg: extra baseline rotation; 0 triggers the optimization.
    """
    w, h = image_size
    ow, oh = out_size if out_size is not None else image_size
    K0i = np.linalg.inv(np.asarray(K0, dtype=np.float64))
    K1i = np.linalg.inv(np.asarray(K1, dtype=np.float64))
    Ri = np.asarray(Rinv, dtype=np.float64)
    ep1 = np.asarray(Tinv, dtype=np.float64).reshape(3)

    Rplane = _rect_plane_rotation(ep1)
    best_angle = angle_deg
    if angle_deg == 0.0:
        best_angle = _optimize_angle(Rplane, K0i, K1i, Ri)
    _, H0, H1 = _homographies_for_angle(best_angle, Rplane, K0i, K1i, Ri)

    pts0 = _corners(w, h)
    pts1 = _corners(w, h)
    q0 = _project(H0, pts0)
    q1 = _project(H1, pts1)

    # Axis-aligned bounds per image (stereorectify.cpp:178-190: x-bounds from
    # left/right corner pairs, y from top/bottom pairs).
    rect0 = (
        min(q0[0, 0], q0[0, 3]), min(q0[1, 0], q0[1, 1]),
        max(q0[0, 1], q0[0, 2]), max(q0[1, 2], q0[1, 3]),
    )
    rect1 = (
        min(q1[0, 0], q1[0, 3]), min(q1[1, 0], q1[1, 1]),
        max(q1[0, 1], q1[0, 2]), max(q1[1, 2], q1[1, 3]),
    )
    top = min(rect0[1], rect1[1])
    bottom = max(rect0[3], rect1[3])

    def scale_translate(rect):
        Tr = np.array([[1, 0, -rect[0]], [0, 1, -top], [0, 0, 1]], dtype=np.float64)
        Sc = np.array(
            [[ow / (rect[2] - rect[0]), 0, 0], [0, oh / (bottom - top), 0], [0, 0, 1]],
            dtype=np.float64,
        )
        return Sc @ Tr

    H0 = scale_translate(rect0) @ H0
    H1 = scale_translate(rect1) @ H1
    H0 = H0 / np.cbrt(np.linalg.det(H0))
    H1 = H1 / np.cbrt(np.linalg.det(H1))

    # Shared ROI: 4th/5th order statistics of the 8 warped corner coords
    # (stereorectify.cpp:216-243) — a close approximation of the maximal
    # common rectangle.
    q0 = _project(H0, pts0)
    q1 = _project(H1, pts1)
    xs = np.sort(np.concatenate([q0[0], q1[0]]))
    ys = np.sort(np.concatenate([q0[1], q1[1]]))
    roi = (int(xs[3]), int(ys[3]), int(xs[4] - int(xs[3])), int(ys[4] - int(ys[3])))
    return RectifyResult(H0, H1, roi, best_angle)


class BouguetResult(NamedTuple):
    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray


def _rodrigues_np(r: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(r)
    if theta < 1e-15:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _inv_rodrigues_np(R: np.ndarray) -> np.ndarray:
    A = (R - R.T) / 2
    rho = np.array([A[2, 1], A[0, 2], A[1, 0]])
    s = np.linalg.norm(rho)
    c = (np.trace(R) - 1) / 2
    if s < 1e-15:
        return np.zeros(3)
    theta = np.arctan2(s, c)
    return rho / s * theta


def stereo_rectify_bouguet(
    K0: np.ndarray, K1: np.ndarray, R: np.ndarray, T: np.ndarray, image_size: Tuple[int, int]
) -> BouguetResult:
    """Bouguet-style rectification (cv::stereoRectify semantics with
    alpha-free focal choice): split the relative rotation between the two
    cameras, align x with the baseline, equalize vertical principal points.
    """
    w, h = image_size
    K0 = np.asarray(K0, dtype=np.float64)
    K1 = np.asarray(K1, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(T, dtype=np.float64).reshape(3)

    om = _inv_rodrigues_np(R)
    r_r = _rodrigues_np(-om * 0.5)
    t_half = r_r @ t

    idx = 0 if abs(t_half[0]) > abs(t_half[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t_half[idx] > 0 else -1.0
    ww = np.cross(t_half, uu)
    nw = np.linalg.norm(ww)
    if nw > 1e-15:
        ww = ww * (np.arccos(abs(t_half[idx]) / np.linalg.norm(t_half)) / nw)
    wR = _rodrigues_np(ww)
    R1 = wR @ r_r
    R2 = wR @ r_r @ R.T
    t_new = R2 @ t

    f_new = min(K0[1, 1], K1[1, 1])
    # New principal points: keep each camera's rotated center centered.
    cc = []
    for K, Rr in ((K0, R1), (K1, R2)):
        pts = _corners(w, h)
        rays = np.linalg.inv(K) @ pts
        rays = Rr @ rays
        proj = rays[:2] / rays[2]
        avg = proj.mean(axis=1)
        cc.append(np.array([(w - 1) / 2, (h - 1) / 2]) - avg * f_new)
    # Horizontal stereo: equalize cy only (reference passes flags=0,
    # wass_stereo.cpp:546).
    cy = (cc[0][1] + cc[1][1]) / 2
    cc[0][1] = cc[1][1] = cy

    P1 = np.array([[f_new, 0, cc[0][0], 0], [0, f_new, cy, 0], [0, 0, 1, 0]])
    P2 = np.array(
        [[f_new, 0, cc[1][0], t_new[idx] * f_new], [0, f_new, cy, 0], [0, 0, 1, 0]]
    )
    Q = np.array(
        [
            [1, 0, 0, -cc[0][0]],
            [0, 1, 0, -cy],
            [0, 0, 0, f_new],
            [0, 0, -1.0 / t_new[idx], (cc[0][0] - cc[1][0]) / t_new[idx]],
        ]
    )
    return BouguetResult(R1, R2, P1, P2, Q)


def bouguet_rectification_homography(K: np.ndarray, Rrect: np.ndarray, Pnew: np.ndarray) -> np.ndarray:
    """The Bouguet route as a plain homography H = Knew @ Rrect @ K^-1, so the
    device-side warp and unrectify share one code path with the custom route
    (valid because inputs are already undistorted)."""
    Knew = np.asarray(Pnew, dtype=np.float64)[:, :3]
    return Knew @ np.asarray(Rrect, dtype=np.float64) @ np.linalg.inv(np.asarray(K, dtype=np.float64))
