"""Infection-immunization dynamics: Nash equilibrium over a payoff matrix.

Functional re-derivation of gt_iidyn
(/root/reference/src/wass_match/iidyn.cpp:520-596): per iteration it picks
the best pure-strategy deviation (infective strategy), mixes it into the
population with the optimal share mu, and incrementally maintains Ax —
O(N) per step.  On device the whole loop is a lax.while_loop whose body is a
handful of (N,)-vector ops + argmax/argmin reductions, with a `mask`
extension (the reference's iidyn_m, :265-336) so candidates removed in
earlier match rounds are excluded without reslicing the payoff matrix —
the N x N payoff is computed once per frame and reused across rounds,
unlike the reference which refills it every round
(GTMatcher.cpp:219-250).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("max_iters",))
def iidyn(
    A: jnp.ndarray,
    x0: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    toll: float = 1e-6,
    max_iters: int = 50000,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run the dynamics.

    Args:
      A: (N, N) payoff matrix (symmetric, nonnegative).
      x0: (N,) initial population (need not be normalized).
      mask: (N,) bool; False entries are frozen out of the game.
      toll: Nash-error tolerance (squared internally, iidyn.cpp:529).
        The reference uses 1e-20 in double precision; in f32 the error
        floor is ~1e-7, so the default here is 1e-6.
      max_iters: iteration cap (reference default 50000,
        GTMatcher.cpp:268).

    Returns:
      (x, n_iters, nash_error).
    """
    N = A.shape[0]
    live = jnp.ones(N, bool) if mask is None else mask

    def simplexify(x):
        x = jnp.where(live, jnp.maximum(x, 0.0), 0.0)
        return x / jnp.maximum(jnp.sum(x), 1e-30)

    x = simplexify(x0)
    Ax = A @ x
    toll2 = toll * toll

    neg_inf = -jnp.inf
    pos_inf = jnp.inf

    def select(x, Ax):
        """selectStrategy (iidyn.cpp:171-208): best infective strategy."""
        xAx = jnp.dot(x, Ax)
        Ax_l = jnp.where(live, Ax, neg_inf)
        max_idx = jnp.argmax(Ax_l)
        maxv = Ax_l[max_idx] - xAx
        Ax_s = jnp.where(live & (x > 0), Ax, pos_inf)
        min_idx = jnp.argmin(Ax_s)
        minv = xAx - Ax_s[min_idx]
        use_max = maxv >= minv
        idx = jnp.where(use_max, max_idx, min_idx)
        delta = jnp.where(use_max, maxv, -minv)
        # Nash error (iidyn.cpp:137-151).
        tmp = jnp.minimum(xAx - Ax, x)
        err = jnp.sum(jnp.where(live, tmp * tmp, 0.0))
        return idx, delta, err, xAx

    def cond(state):
        x, Ax, it, err = state
        return (it < max_iters) & (err >= toll2)

    def body(state):
        x, Ax, it, _ = state
        idx, delta, err, xAx = select(x, Ax)

        den = A[idx, idx] - Ax[idx] - delta
        # mu for the infective case (delta >= 0): min(1, -delta/den if den<0).
        mu_pos = jnp.where(den < 0, jnp.clip(-delta / den, 0.0, 1.0), 1.0)
        # Immunization case (delta < 0): start from x/(x-1) (<= 0), possibly
        # raised to -delta/den, removal if not raised (iidyn.cpp:558-572).
        mu0 = x[idx] / (x[idx] - 1.0)
        raised = (den < 0) & (-delta / den > mu0)
        mu_neg = jnp.where(raised, jnp.minimum(-delta / den, 0.0), mu0)
        remove = (delta < 0) & ~raised

        infective = delta >= 0
        mu = jnp.where(infective, mu_pos, mu_neg)

        x_new = x * (1.0 - mu)
        x_new = x_new.at[idx].set(jnp.where(remove, 0.0, x_new[idx] + mu))
        x_new = simplexify(x_new)
        Ax_new = Ax + mu * (A[idx, :] - Ax)
        return x_new, Ax_new, it + 1, err

    # Prime the loop with err=inf so cond runs the first body.
    x, Ax, it, err = jax.lax.while_loop(cond, body, (x, Ax, jnp.int32(0), jnp.inf))
    _, _, final_err, _ = select(x, Ax)
    return x, it, jnp.sqrt(final_err)


def initial_population(key: jax.Array, n: int, mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Barycenter + up to 3% jitter (gt_create_population, iidyn.cpp:601-612)."""
    x = 1.0 + jax.random.uniform(key, (n,)) * (n * 0.03)
    if mask is not None:
        x = jnp.where(mask, x, 0.0)
    return x / jnp.sum(x)
