"""Mean-sea-plane estimation: RANSAC + weighted least-squares refinement.

Batched device form of PovMesh::ransac_find_plane / refine_plane / crop_plane
(/root/reference/src/wass_stereo/PovMesh.cpp:665-815): instead of 400
sequential rounds, all hypotheses are drawn and scored as one batched
program — hypothesis generation is a gather, inlier counting is a masked
reduction over the full point grid, vmapped over rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


class PlaneFit(NamedTuple):
    plane: jnp.ndarray  # (4,) a, b, c, d with ||n|| = 1, c >= 0
    n_inliers: jnp.ndarray
    ok: jnp.ndarray  # bool: inliers >= 10% of valid points (PovMesh.cpp:772)


# Gate quantities (RANSAC inlier distances, the refinement's centroid and
# covariance) are float32 products pinned to HIGHEST: a GPU may otherwise
# run them in TF32 (~3 decimal digits), which moves points across the
# inlier threshold.


def plane_distance(plane: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(jnp.matmul(pts, plane[:3], precision=jax.lax.Precision.HIGHEST) + plane[3])


def ransac_find_plane(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    rounds: int = 400,
    distance_threshold: float = 1.0,
) -> PlaneFit:
    """Fit a plane to the valid points of a (H, W, 3) grid by RANSAC.

    Mirrors PovMesh.cpp:665-777: 3 random *pixel locations* per round (at
    least 1% of the image height apart), plane through their 3D points with
    the normal flipped toward the camera (+z), scored by inliers within
    distance_threshold.  Rounds whose pixels are invalid or degenerate are
    scored 0 (the reference retries; with a fixed hypothesis budget the
    valid ones dominate).
    """
    H, W, _ = points.shape
    mindist = H * 0.01

    k1, k2 = jax.random.split(key)
    uv = jax.random.randint(k1, (rounds, 3, 2), 0, jnp.array([W, H]))  # (rounds, 3, [x, y])

    # Inlier counting runs on a strided subsample on large frames: the
    # count is only used to *rank* hypotheses, and a systematic sample
    # ranks identically in practice while cutting the rounds x pixels
    # traffic (the refine stage still uses every point).  At 3 MP the
    # stride-4 sample still scores ~200k points per hypothesis.
    npix = H * W
    stride = 4 if npix > (1 << 21) else (2 if npix > (1 << 20) else 1)
    pts_s = points[::stride, ::stride].reshape(-1, 3)
    valid_s = valid[::stride, ::stride].reshape(-1)

    def hypo(uv3):
        """Plane hypothesis from 3 pixel picks (no scoring here)."""
        px = uv3[:, 0]
        py = uv3[:, 1]
        far = (
            (jnp.hypot(*(uv3[0] - uv3[1]).astype(jnp.float32).T) >= mindist)
            & (jnp.hypot(*(uv3[1] - uv3[2]).astype(jnp.float32).T) >= mindist)
            & (jnp.hypot(*(uv3[0] - uv3[2]).astype(jnp.float32).T) >= mindist)
        )
        ok3 = valid[py[0], px[0]] & valid[py[1], px[1]] & valid[py[2], px[2]]
        p1 = points[py[0], px[0]]
        p2 = points[py[1], px[1]]
        p3 = points[py[2], px[2]]
        n = jnp.cross(p2 - p1, p3 - p1)
        norm = jnp.linalg.norm(n)
        n = n / jnp.maximum(norm, 1e-20)
        n = jnp.where(n[2] < 0, -n, n)
        d = -jnp.dot(n, p1)
        good = far & ok3 & (norm > 1e-12)
        return good, jnp.concatenate([n, d[None]])

    good, planes = jax.vmap(hypo)(uv)
    # Score every hypothesis in ONE streaming pass over the subsample
    # (an (N, 3) x (3, rounds) product) instead of `rounds` separate
    # passes — the per-round formulation re-read the point sample 400
    # times.  f32 precision: inlier membership at the threshold must not
    # wobble with reduced-precision matmul passes.
    dist = jnp.abs(
        jnp.einsum(
            "nc,rc->nr", pts_s, planes[:, :3],
            precision=jax.lax.Precision.HIGHEST,
        )
        + planes[None, :, 3]
    )
    counts = jnp.sum(
        (dist < distance_threshold) & valid_s[:, None], axis=0, dtype=jnp.int32
    )
    counts = jnp.where(good, counts, 0)
    best = jnp.argmax(counts)
    n_valid = jnp.sum(valid_s)
    return PlaneFit(planes[best], counts[best], counts[best] >= n_valid // 10)


def crop_plane(plane: jnp.ndarray, points: jnp.ndarray, valid: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Invalidate points farther than threshold from the plane
    (PovMesh::crop_plane, PovMesh.cpp:780-815)."""
    return valid & (plane_distance(plane, points) < threshold)


def refine_plane(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    max_distance: float = 70.0,
    weight_by_distance: bool = True,
    bbox: Optional[Tuple[float, float, float, float]] = None,
) -> jnp.ndarray:
    """Weighted LLS plane (PovMesh::refine_plane, PovMesh.cpp:581-660):
    camera-distance weights, weighted centroid + covariance, normal = the
    smallest singular vector, normal flipped toward the camera.

    bbox = (xmin, xmax, ymin, ymax) point-coordinate crop
    (PLANE_REFINE_{X,Y}{MIN,MAX}).
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dist = jnp.sqrt(x * x + y * y + z * z)
    m = valid & (dist < max_distance)
    if bbox is not None:
        xmin, xmax, ymin, ymax = bbox
        m = m & (x > xmin) & (x < xmax) & (y > ymin) & (y < ymax)
    w = jnp.where(m, dist if weight_by_distance else 1.0, 0.0)
    wsum = jnp.maximum(jnp.sum(w), 1e-20)
    centroid = jnp.einsum("...c,...->c", points, w, precision=jax.lax.Precision.HIGHEST) / wsum
    diff = jnp.where(m[..., None], points - centroid, 0.0)
    A = jnp.einsum(
        "...i,...j,...->ij", diff, diff, jnp.where(m, w, 0.0),
        precision=jax.lax.Precision.HIGHEST,
    )
    # Smallest eigenvector of the 3x3 weighted covariance.
    evals, evecs = jnp.linalg.eigh(A)
    n = evecs[:, 0]
    n = n / jnp.maximum(jnp.linalg.norm(n), 1e-20)
    n = jnp.where(n[2] < 0, -n, n)
    d = -jnp.dot(n, centroid)
    return jnp.concatenate([n, d[None]])
