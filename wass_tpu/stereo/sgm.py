"""Semi-global matching cost aggregation + disparity extraction.

This replaces cv::StereoSGBM::compute — the hottest loop of the entire
reference pipeline (/root/reference/src/wass_stereo/wass_stereo.cpp:837,
SURVEY.md §3.4).  The SGM recurrence along a scan direction r is

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2 ) - min_k L_r(p-r, k)

Two implementations with identical integer results:

  * sgm_aggregate, the plain JAX reference: each direction pair is one
    lax.scan whose carry is an (H, D) or (W, D) slab; diagonal directions
    reuse the row scan with a per-step lateral shift of the carry.
  * sgm_aggregate_cuda, the CUDA kernel (wass_tpu/kernels/
    sgm_aggregate.cu): one warp walks each scan line.

aggregate() picks one from the platform JAX compiles for.

All aggregation is integer (int16): census costs are <= 64, so the
normalized per-direction bound is max_cost + P2 and an 8-direction sum
stays well inside int16.

Windowed volumes (coarse-to-fine search, stereo/c2f.py): with per-row
offsets, lane j of row y means disparity offsets[y] + j.  Vertical and
diagonal paths realign their carry when the offset changes between rows;
lanes that enter the window start from the no-predecessor value.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

INVALID = jnp.float32(0.0)  # invalid disparity marker (reference uses 0)

_BIG = jnp.int16(32000)


def _sgm_step(prev: jnp.ndarray, cost: jnp.ndarray, P1: int, P2: int) -> jnp.ndarray:
    """One SGM update: prev, cost are (..., D) int16 -> (..., D) int16."""
    minprev = jnp.min(prev, axis=-1, keepdims=True)
    up = jnp.concatenate([prev[..., :1] * 0 + _BIG, prev[..., :-1]], axis=-1)
    dn = jnp.concatenate([prev[..., 1:], prev[..., :1] * 0 + _BIG], axis=-1)
    best = jnp.minimum(
        jnp.minimum(prev, minprev + jnp.int16(P2)),
        jnp.minimum(up, dn) + jnp.int16(P1),
    )
    return cost + best - minprev


def _realign(carry: jnp.ndarray, delta) -> jnp.ndarray:
    """Carry of a row with window offset o_prev re-expressed at offset
    o_prev + delta: new[..., j] = carry[..., j + delta], BIG where j + delta
    leaves the window."""
    D = carry.shape[-1]
    j = jnp.arange(D, dtype=jnp.int32) + delta
    moved = jnp.take(carry, jnp.clip(j, 0, D - 1), axis=-1)
    return jnp.where((j >= 0) & (j < D), moved, _BIG)


def _pair_scan(cost_fn, n_steps: int, slab_shape, P1: int, P2: int, emit_dtype, shift: int = 0,
               deltas=None):
    """Run the forward and backward SGM recurrences of one direction pair in
    a single scan.

    cost_fn(i) -> (slab_fwd, slab_bwd): the cost slabs consumed by the
    forward pass at step i and by the backward pass at its own step i
    (position n-1-i), gathered on the fly from the cost volume — no
    stacked/flipped input copies are materialized.

    deltas (optional): (n_steps,) int32 window-offset change of each
    position relative to the previous one (deltas[0] unused); the forward
    carry realigns by deltas[i] before step i, the backward carry by
    -deltas[n-i] (the change seen walking the other way).

    Returns (ys_fwd, ys_bwd): per-step aggregated slabs, emitted in
    emit_dtype (uint8 when C_max + P2 < 256 — the classic SGM bound
    L <= C + P2 after min-normalization — halving each direction volume).
    """

    def step(carry, i):
        fwd, bwd = carry
        if deltas is not None:
            fwd = _realign(fwd, jnp.where(i > 0, deltas[i], 0))
            bwd = _realign(bwd, jnp.where(i > 0, -deltas[(n_steps - i) % n_steps], 0))
        if shift != 0:
            fwd = jnp.roll(fwd, shift, axis=-2)
            bwd = jnp.roll(bwd, -shift, axis=-2)
            if shift > 0:
                fwd = fwd.at[..., :shift, :].set(_BIG)
                bwd = bwd.at[..., -shift:, :].set(_BIG)
            else:
                fwd = fwd.at[..., shift:, :].set(_BIG)
                bwd = bwd.at[..., :-shift, :].set(_BIG)
        cf, cb = cost_fn(i)
        fwd = _sgm_step(fwd, cf.astype(jnp.int16), P1, P2)
        bwd = _sgm_step(bwd, cb.astype(jnp.int16), P1, P2)
        return (fwd, bwd), (fwd.astype(emit_dtype), bwd.astype(emit_dtype))

    init = (
        jnp.full(slab_shape, _BIG, jnp.int16),
        jnp.full(slab_shape, _BIG, jnp.int16),
    )
    _, (ys_f, ys_b) = jax.lax.scan(step, init, jnp.arange(n_steps))
    return ys_f, ys_b


def sgm_aggregate(
    cost: jnp.ndarray, P1: int, P2: int, directions: int = 8,
    offsets: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Aggregate an (H, W, D) uint8 cost volume over SGM paths (the plain
    JAX reference).

    directions: 2 (horizontal), 4 (+vertical), 5 (the cv::StereoSGBM
    default MODE_SGBM path set: E, W, N, NW, NE — the reference runs this,
    wass_stereo.cpp:775 creates SGBM without setting MODE_HH) or 8 (full
    two-pass path set, MODE_HH equivalent).
    offsets: optional (H,) int32 per-row window offsets of a windowed
    volume (None = one disparity range for every row).
    Returns (H, W, D) int16 aggregated cost sum.

    Memory plan: the cost volume stays uint8; each direction pair is one
    scan whose per-step slabs are gathered from the volume (no flipped
    input copies) and whose outputs are emitted uint8 (the normalized
    per-direction cost is bounded by C_max + P2 < 256); the int16 sum is
    the only full-precision volume.
    """
    assert directions in (2, 4, 5, 8)
    c = cost if cost.dtype == jnp.uint8 else cost.astype(jnp.uint8)
    H, W, D = c.shape
    emit = jnp.uint8
    assert 64 + P2 < 256, "P2 too large for uint8 direction emissions"
    deltas = None
    if offsets is not None:
        off = offsets.astype(jnp.int32)
        deltas = off - jnp.concatenate([off[:1], off[:-1]])

    # Horizontal pair: scan over x, slabs are (H, D) columns.
    cT = jnp.transpose(c, (1, 0, 2))  # (W, H, D) uint8 for axis-0 slicing

    def cost_h(i):
        return cT[i], cT[W - 1 - i]

    hf, hb = _pair_scan(cost_h, W, (H, D), P1, P2, emit)  # (W, H, D) each
    agg = (
        jnp.transpose(hf, (1, 0, 2)).astype(jnp.int16)
        + jnp.transpose(hb[::-1], (1, 0, 2)).astype(jnp.int16)
    )

    def cost_v(i):
        return c[i], c[H - 1 - i]

    def vscan(shift=0):
        return _pair_scan(cost_v, H, (W, D), P1, P2, emit, shift=shift, deltas=deltas)

    if directions >= 4:
        vf, vb = vscan()
        if directions == 5:
            # 5-path: N + NW + NE forward halves only (single top-down
            # pass like the OpenCV default).
            agg = agg + vf.astype(jnp.int16)
            d1f, _ = vscan(1)
            d2f, _ = vscan(-1)
            return agg + d1f.astype(jnp.int16) + d2f.astype(jnp.int16)
        agg = agg + vf.astype(jnp.int16) + vb[::-1].astype(jnp.int16)

    if directions == 8:
        # Diagonal pairs: scan over y; the forward half walks down-right
        # while the backward half walks up-right (and mirrored for the
        # second pair), realized by opposite lateral rolls of the carries.
        d1f, d1b = vscan(1)
        agg = agg + d1f.astype(jnp.int16) + d1b[::-1].astype(jnp.int16)
        d2f, d2b = vscan(-1)
        agg = agg + d2f.astype(jnp.int16) + d2b[::-1].astype(jnp.int16)

    return agg


def sgm_aggregate_cuda(
    cost: jnp.ndarray, P1: int, P2: int, directions: int = 8,
    offsets: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """sgm_aggregate through the CUDA kernel (same arguments, same result).

    The kernel reads each pixel's disparities with 4-byte vector loads, so
    the disparity axis is zero-padded to a multiple of 4 and the padding
    sliced off the result; the kernel treats lanes past D as absent.
    """
    from wass_tpu.kernels import ensure_registered

    if directions not in (2, 4, 5, 8):
        raise ValueError(f"directions must be 2, 4, 5 or 8, not {directions}")
    if not 64 + P2 < 256:
        raise ValueError(f"P2={P2} breaks the uint8 per-direction bound 64 + P2 < 256")
    ensure_registered()
    c = cost if cost.dtype == jnp.uint8 else cost.astype(jnp.uint8)
    H, W, D = c.shape
    Dp = -(-D // 4) * 4
    if Dp != D:
        c = jnp.pad(c, ((0, 0), (0, 0), (0, Dp - D)))
    windowed = offsets is not None
    off = offsets.astype(jnp.int32) if windowed else jnp.zeros((H,), jnp.int32)
    agg = jax.ffi.ffi_call(
        "wass_sgm_aggregate", jax.ShapeDtypeStruct((H, W, Dp), jnp.int16)
    )(
        c, off,
        num_disp=int(D), p1=int(P1), p2=int(P2), directions=int(directions),
        windowed=int(windowed),
    )
    return agg[..., :D] if Dp != D else agg


def aggregate(
    cost: jnp.ndarray, P1: int, P2: int, directions: int = 8,
    offsets: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """SGM aggregation for the platform JAX compiles for: the CUDA kernel
    on a GPU, the plain JAX reference on the CPU.  Any other platform is
    an error, and so is a GPU whose kernel library cannot be built."""
    platform = jax.default_backend()
    if platform == "gpu":
        return sgm_aggregate_cuda(cost, P1, P2, directions, offsets)
    if platform == "cpu":
        return sgm_aggregate(cost, P1, P2, directions, offsets)
    raise RuntimeError(f"no SGM aggregation for platform {platform!r}")


def wta_disparity(
    agg: jnp.ndarray,
    min_disp: int,
    uniqueness_ratio: int = 1,
    lr_max_diff: int = -1,
) -> jnp.ndarray:
    """Winner-take-all + parabola subpixel + uniqueness + optional LR check.

    Mirrors the StereoSGBM post-steps configured by the reference
    (uniquenessRatio/disp12MaxDiff, wass_stereo.cpp:779-781).  Returns float
    disparity (in the base=right convention); 0 marks invalid.
    """
    H, W, D = agg.shape
    didx = jnp.arange(D, dtype=jnp.int32)[None, None, :]

    # Gather-free formulation: every per-pixel quantity is a masked
    # reduction over the D axis, with no argmin/take_along_axis gather
    # at (H, W, D).  XLA fuses each broadcast+select into its reduction,
    # so the volume streams from HBM a handful of times and nothing
    # (H, W, D)-sized materializes.
    a = agg.astype(jnp.int32)
    dmin = jnp.min(a, axis=-1)
    best = jnp.min(jnp.where(a == dmin[..., None], didx, D), axis=-1)

    big = jnp.int32(1 << 30)
    sm1 = jnp.min(jnp.where(didx == best[..., None] - 1, a, big), axis=-1)
    sp1 = jnp.min(jnp.where(didx == best[..., None] + 1, a, big), axis=-1)

    # Uniqueness: any cost within ratio at |d - best| > 1 invalidates.
    far_min = jnp.min(jnp.where(jnp.abs(didx - best[..., None]) > 1, a, big), axis=-1)
    thresh = dmin * (100 + uniqueness_ratio) // 100
    valid = far_min > thresh

    # Parabola subpixel around the winner.
    interior = (best > 0) & (best < D - 1)
    sm1s = jnp.where(interior, sm1, dmin)
    sp1s = jnp.where(interior, sp1, dmin)
    denom = jnp.maximum(sm1s + sp1s - 2 * dmin, 1)
    delta = jnp.clip((sm1s - sp1s) / (2.0 * denom), -0.5, 0.5)
    disp = (best + min_disp + jnp.where(interior, delta, 0.0)).astype(jnp.float32)

    if lr_max_diff >= 0:
        # Left-base disparity from the same aggregated volume:
        # dispL(y, xl) = argmin_d agg(y, xl + d, d), as a running-min fold
        # over d to avoid materializing a second volume.
        def fold(carry, j):
            bc, bv = carry
            cols = (jnp.arange(W) + j + min_disp) % W  # traced-shift roll
            v = jnp.take(agg[:, :, j], cols, axis=1)
            better = v < bv
            return (jnp.where(better, j, bc), jnp.minimum(v, bv)), None

        init = (jnp.zeros((H, W), jnp.int32), jnp.full((H, W), _BIG, agg.dtype))
        (bestL, _), _ = jax.lax.scan(fold, init, jnp.arange(D))
        bestL = bestL + min_disp
        xr_pix = jnp.arange(W)[None, :]
        xl_pix = jnp.clip(xr_pix - (best + min_disp), 0, W - 1)
        dL = jnp.take_along_axis(bestL, xl_pix, axis=1)
        valid = valid & (jnp.abs((best + min_disp) - dL) <= lr_max_diff)

    return jnp.where(valid, disp, 0.0).astype(jnp.float32)


def sgm_disparity(
    base_img: jnp.ndarray,
    match_img: jnp.ndarray,
    num_disp: int,
    min_disp: int = 1,
    P1: int = 8,
    P2: int = 96,
    directions: int = 8,
    census_win: Tuple[int, int] = (7, 9),
    uniqueness_ratio: int = 1,
    lr_max_diff: int = -1,
    input_smooth_sigma: float = 0.0,
) -> jnp.ndarray:
    """End-to-end dense disparity: census -> cost volume -> SGM -> WTA.

    base_img is the *right* rectified image (the reference's base,
    wass_stereo.cpp:837 passes (right, left)); match_img is the left.
    """
    from wass_tpu.stereo.cost import census_transform, census_cost_volume

    cb = census_transform(base_img, census_win, input_smooth_sigma)
    cm = census_transform(match_img, census_win, input_smooth_sigma)
    cost = census_cost_volume(cb, cm, num_disp, min_disp)
    agg = aggregate(cost, P1, P2, directions)
    return wta_disparity(agg, min_disp, uniqueness_ratio, lr_max_diff)
