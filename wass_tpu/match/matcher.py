"""Game-theoretic feature matching as dense matrix products.

Device re-architecture of GTMatcher (/root/reference/src/wass_match/GTMatcher.cpp):

* candidate generation: dense descriptor distance matrix (one matmul) +
  top-k (replaces FLANN KD-tree kNN, FeatureSet.cpp:419-468), with the
  NNDR shortlist heuristic (GTMatcher.cpp:197-205);
* payoff matrix: pairwise affine-consistency payoffs (:69-141) built once
  as a batched outer computation (the O(N^2) hot loop of the reference,
  :237-247, becomes a handful of broadcast ops);
* match rounds: infection-immunization dynamics (iidyn) selects a
  mutually-consistent group; winners are extracted and all candidates
  sharing a winner's source or target are masked out; repeat
  (wass_match.cpp:218-239).  Rounds mask the single precomputed payoff
  matrix instead of rebuilding it.

Fixed shapes: K features/image, C = K * n_candidates associations, masks
throughout.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from wass_tpu.match.features import FeatureSet
from wass_tpu.match.iidyn import iidyn, initial_population


class Candidates(NamedTuple):
    src: jnp.ndarray  # (C,) int32 index into feature set A
    dst: jnp.ndarray  # (C,) int32 index into feature set B
    valid: jnp.ndarray  # (C,) bool
    nndr_best: jnp.ndarray  # (C,) bool — passed the NNDR shortlist test


class MatchResult(NamedTuple):
    src: jnp.ndarray  # (M,) indices into A (M = capacity)
    dst: jnp.ndarray  # (M,) indices into B
    valid: jnp.ndarray  # (M,) bool
    n_rounds: jnp.ndarray


def generate_candidates(fa: FeatureSet, fb: FeatureSet, n_per_feature: int = 3, nndr: float = 0.25) -> Candidates:
    """kNN candidates via a matrix-product distance matrix
    (GTMatcher.cpp:180-216).  HIGHEST precision: the NNDR ratio test and the
    neighbour order must not change with TF32 products on a GPU."""
    K = fa.desc.shape[0]
    d2 = (
        jnp.sum(fa.desc**2, -1, keepdims=True)
        + jnp.sum(fb.desc**2, -1)[None, :]
        - 2.0 * jnp.matmul(fa.desc, fb.desc.T, precision=jax.lax.Precision.HIGHEST)
    )
    big = jnp.float32(1e10)
    d2 = jnp.where(fa.valid[:, None] & fb.valid[None, :], d2, big)
    # top-(n+1) nearest for NNDR (need the 2nd-best distance).
    neg, idx = jax.lax.top_k(-d2, n_per_feature + 1)
    dist = jnp.sqrt(jnp.maximum(-neg, 0.0))
    # NNDR heuristic (GTMatcher.cpp:197): best << second-best.
    nndr_ok = dist[:, 0] < nndr * dist[:, 1]

    src = jnp.repeat(jnp.arange(K, dtype=jnp.int32), n_per_feature)
    dst = idx[:, :n_per_feature].reshape(-1).astype(jnp.int32)
    valid = jnp.repeat(fa.valid, n_per_feature) & (dist[:, :n_per_feature].reshape(-1) < 1e4)
    first_of_feature = (jnp.arange(K * n_per_feature) % n_per_feature) == 0
    nndr_best = jnp.repeat(nndr_ok, n_per_feature) & first_of_feature
    return Candidates(src, dst, valid, nndr_best)


def _affine_params(fa: FeatureSet, fb: FeatureSet, cand: Candidates):
    """Per-candidate similarity transform (association::compute_affine,
    GTMatcher.cpp:69-97): rotation = angle difference, scale ratio, and the
    translation that maps the source feature onto the target."""
    a = fb.angle[cand.dst]
    b = fa.angle[cand.src]
    diff = jnp.mod(b - a + jnp.pi, 2 * jnp.pi) - jnp.pi  # ang_diff (:47-52)
    cos_a = jnp.cos(diff)
    sin_a = jnp.sin(diff)
    dscale = fb.scale[cand.dst] / jnp.maximum(fa.scale[cand.src], 1e-12)
    sx = fa.xy[cand.src, 0] * dscale
    sy = fa.xy[cand.src, 1] * dscale
    rx = sx * cos_a - sy * sin_a
    ry = sx * sin_a + sy * cos_a
    dx = fb.xy[cand.dst, 0] - rx
    dy = fb.xy[cand.dst, 1] - ry
    return cos_a, sin_a, dscale, dx, dy


def payoff_matrix(fa: FeatureSet, fb: FeatureSet, cand: Candidates, lam: float = 1e-5) -> jnp.ndarray:
    """(C, C) payoff = exp(-lambda * symmetric affine-transfer error)
    (GTMatcher.cpp:101-141), zero for candidates sharing a source or target
    (one-to-one constraint) and for invalid candidates."""
    cos_a, sin_a, dscale, dx, dy = _affine_params(fa, fb, cand)
    sxy = fa.xy[cand.src]  # (C, 2)
    txy = fb.xy[cand.dst]

    # Apply candidate i's transform to candidate j's source feature.
    def transfer_err(cos_i, sin_i, ds_i, dx_i, dy_i, sx_j, sy_j, tx_j, ty_j):
        ex = tx_j - (ds_i * (sx_j * cos_i - sy_j * sin_i) + dx_i)
        ey = ty_j - (ds_i * (sx_j * sin_i + sy_j * cos_i) + dy_i)
        return ex * ex + ey * ey

    e_ij = transfer_err(
        cos_a[:, None], sin_a[:, None], dscale[:, None], dx[:, None], dy[:, None],
        sxy[None, :, 0], sxy[None, :, 1], txy[None, :, 0], txy[None, :, 1],
    )
    ge = jnp.maximum(e_ij, e_ij.T)  # symmetric max (geometric_error :101-124)
    pay = jnp.exp(-lam * ge)

    same_src = cand.src[:, None] == cand.src[None, :]
    same_dst = cand.dst[:, None] == cand.dst[None, :]
    ok = cand.valid[:, None] & cand.valid[None, :] & ~(same_src | same_dst)
    pay = jnp.where(ok, pay, 0.0)
    # Zero diagonal (payoff() returns 0 when a1 == a2 shares src/target).
    return pay * (1.0 - jnp.eye(pay.shape[0], dtype=pay.dtype))


@partial(jax.jit, static_argnames=("max_rounds", "min_group_size", "iidyn_iters"))
def gt_match(
    fa: FeatureSet,
    fb: FeatureSet,
    cand: Candidates,
    pay: jnp.ndarray,
    key: jax.Array,
    pop_threshold: float = 0.7,
    max_rounds: int = 20,
    min_group_size: int = 5,
    iidyn_iters: int = 20000,
) -> MatchResult:
    """Run up to max_rounds match-group extractions (wass_match.cpp:218-239).

    Returns per-candidate winner flags folded into a fixed-size match list
    (capacity = C): candidate i is a match iff winner_mask[i].
    """
    C = pay.shape[0]

    def round_body(state):
        live, winners, rnd, go, key = state
        key, sub = jax.random.split(key)
        x0 = initial_population(sub, C, live)
        x, _, _ = iidyn(pay, x0, mask=live, max_iters=iidyn_iters)
        thresh = jnp.max(x) * pop_threshold
        group = (x > thresh) & live
        gsize = jnp.sum(group)
        # Remove candidates sharing a winning source or target
        # (GTMatcher.cpp:300-315).
        win_src = jnp.where(group, cand.src, -1)
        win_dst = jnp.where(group, cand.dst, -1)
        hit_src = jnp.isin(cand.src, win_src)
        hit_dst = jnp.isin(cand.dst, win_dst)
        live = live & ~(hit_src | hit_dst)
        winners = winners | group
        go = gsize >= min_group_size
        return live, winners, rnd + 1, go, key

    def cond(state):
        live, winners, rnd, go, key = state
        return go & (rnd < max_rounds) & (jnp.sum(live) > 0)

    live0 = cand.valid
    winners0 = jnp.zeros(C, bool)
    live, winners, rounds, _, _ = jax.lax.while_loop(
        cond, round_body, (live0, winners0, jnp.int32(0), True, key)
    )
    return MatchResult(src=cand.src, dst=cand.dst, valid=winners, n_rounds=rounds)


def nearest_match(cand: Candidates) -> MatchResult:
    """MATCHER_SKIP_GT path (wass_match.cpp:44,300-304): NNDR winners only."""
    return MatchResult(
        src=cand.src, dst=cand.dst, valid=cand.nndr_best & cand.valid, n_rounds=jnp.int32(0)
    )
