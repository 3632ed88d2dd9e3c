"""Local-plane outlier voting for aligned point clouds.

Re-design of the reference's filter_mesh_outliers
(/root/reference/gridding/wassgridsurface/wass_utils.py:72-163): the
reference scans a 15x15 grid of probe centers, KD-tree-gathers points
within 0.5 radius, runs a 100-round 3-point plane RANSAC per probe, and
drops every point that is an outlier of any local fit.

Device-side equivalent with identical intent (drop points inconsistent
with the *local* sea surface) but no KD-tree and no per-probe python
loop: points are binned into the same 15x15 cells, and each cell gets a
robust local plane via 3 rounds of iteratively-reweighted least squares
(fit -> mask points beyond the inlier threshold -> refit), computed for
ALL cells at once with segment-sum moment accumulation.  A point is
voted out when it exceeds the threshold against its own cell's
converged plane.  IRLS with a hard threshold has the same breakdown
behavior as the reference's RANSAC here because the sea surface is the
dominant population in every cell.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

N_CELLS = 15  # reference scan grid (wass_utils.py:134)


@partial(jax.jit, static_argnames=("n_cells", "irls_rounds"))
def _vote_device(pts, threshold, n_cells: int = N_CELLS, irls_rounds: int = 3):
    """pts: (N, 3) float32 aligned points -> (N,) bool keep mask."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    xmin, xmax = jnp.min(x), jnp.max(x)
    ymin, ymax = jnp.min(y), jnp.max(y)
    cx = jnp.clip(((x - xmin) / jnp.maximum(xmax - xmin, 1e-9) * n_cells).astype(jnp.int32), 0, n_cells - 1)
    cy = jnp.clip(((y - ymin) / jnp.maximum(ymax - ymin, 1e-9) * n_cells).astype(jnp.int32), 0, n_cells - 1)
    cell = cy * n_cells + cx
    n_seg = n_cells * n_cells

    w = jnp.ones_like(z)

    def seg(v):
        return jax.ops.segment_sum(v, cell, num_segments=n_seg)

    dist = jnp.zeros_like(z)
    for _ in range(irls_rounds):
        # Weighted plane z = a x + b y + c per cell: normal equations from
        # segment-summed moments (3x3 solve per cell).
        sw = seg(w)
        sx, sy, sz = seg(w * x), seg(w * y), seg(w * z)
        sxx, sxy, syy = seg(w * x * x), seg(w * x * y), seg(w * y * y)
        sxz, syz = seg(w * x * z), seg(w * y * z)
        A = jnp.stack(
            [
                jnp.stack([sxx, sxy, sx], -1),
                jnp.stack([sxy, syy, sy], -1),
                jnp.stack([sx, sy, sw], -1),
            ],
            -2,
        )
        b = jnp.stack([sxz, syz, sz], -1)
        A = A + jnp.eye(3) * 1e-6
        abc = jnp.linalg.solve(A, b[..., None])[..., 0]  # (n_seg, 3)
        a_p, b_p, c_p = abc[cell, 0], abc[cell, 1], abc[cell, 2]
        denom = jnp.sqrt(a_p**2 + b_p**2 + 1.0)
        dist = jnp.abs(a_p * x + b_p * y + c_p - z) / denom
        w = (dist < threshold).astype(jnp.float32)

    # Degenerate cells (fewer than 4 surviving points) keep everything.
    enough = seg(w) >= 4
    return (dist < threshold) | ~enough[cell]


def filter_mesh_outliers(mesh_aligned: np.ndarray, ransac_inlier_threshold: float = 0.2) -> np.ndarray:
    """mesh_aligned: (3, N) sea-plane-aligned points (meters).  Returns the
    filtered (3, M) cloud, like the reference function."""
    pts = np.ascontiguousarray(mesh_aligned.T, np.float32)
    if pts.shape[0] < 16:
        return mesh_aligned
    keep = np.asarray(_vote_device(jnp.asarray(pts), jnp.float32(ransac_inlier_threshold)))
    return mesh_aligned[:, keep]
