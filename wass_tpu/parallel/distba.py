"""Distributed Schur-complement bundle adjustment over a device mesh.

The reference's autocalibration gathers every frame's matches onto one
process and runs libsba serially (SURVEY.md §3.3).  Here the pooled point
blocks are *sharded across devices*: each shard computes its local point
Jacobians, 3x3 block inverses and Schur contributions, and only the tiny
reduced camera system (6x6 + gradient + scalar cost) crosses the
interconnect via psum each LM iteration — O(100 bytes) of traffic per
step regardless of point count.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wass_tpu.calib.ba import BAResult, lm_refine_two_view


def lm_refine_two_view_sharded(
    mesh: Mesh,
    R_init,
    T_init,
    X_init,
    p0,
    p1,
    mask,
    max_iters: int = 50,
    axis: str = "frame",
) -> BAResult:
    """Point-sharded LM over `mesh` (1-D, axis name `axis`).

    Per-point arrays (X_init, p0, p1, mask) are sharded on their leading
    axis; camera parameters are replicated.  The point count must divide by
    the mesh size (pad with mask=False slots).
    """
    n_dev = mesh.shape[axis]
    N = X_init.shape[0]
    assert N % n_dev == 0, "pad the point batch to a multiple of the mesh size"

    fn = partial(lm_refine_two_view, max_iters=max_iters, axis_name=axis)
    sharded = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=BAResult(
            R=P(), T=P(), X=P(axis), initial_cost=P(), final_cost=P(), n_iters=P()
        ),
        check_vma=False,
    )
    return sharded(R_init, T_init, X_init, p0, p1, mask)


def pad_points_for_mesh(arrs, mask, n_dev: int):
    """Pad leading axes to a multiple of n_dev; extend mask with False."""
    N = mask.shape[0]
    pad = (-N) % n_dev
    if pad == 0:
        return arrs, mask
    out = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) for a in arrs]
    m = np.concatenate([mask, np.zeros(pad, bool)])
    return out, m
