"""Coarse-to-fine disparity windowing for dense SGM.

The reference searches a fixed global range (MIN_DISPARITY=1,
MAX_DISPARITY=640 by default, /root/reference/src/wass_stereo/
wass_stereo.cpp:742-744) for every pixel.  On an obliquely-viewed sea
surface the disparity is nearly a function of the image row (distance
grows towards the horizon), so the full range is ~5x wider than any one
row needs.  This module runs the full-range SGM at 1/factor resolution,
derives a per-row-tile disparity window from the coarse map, and runs
the full-resolution census/SGM/WTA only inside the window:

    cost volume, aggregation and WTA shrink by num_disp / win_disp,
    making the frame time nearly independent of the search range.

Window robustness: per-row coarse min/max are smoothed over neighbor
rows, rows with no coarse evidence inherit the global range, and the
window is centered so a (win - rowrange)/2 margin guards against coarse
quantization error.  The windowed cost volume and aggregation are the
ordinary ones with per-row offsets (stereo/cost.census_cost_volume,
stereo/sgm.aggregate); this module holds the windows and the orchestration.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from wass_tpu.stereo.cost import census_cost_volume, census_transform
from wass_tpu.stereo.sgm import aggregate, sgm_disparity, wta_disparity

TILE_ROWS = 8  # rows that share one disparity window


def downsample_pool(img: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Mean-pool downsample (no gathers; adequate antialiasing for the
    coarse census pass)."""
    H, W = img.shape
    return img.reshape(H // factor, factor, W // factor, factor).mean(axis=(1, 3))


def _shift_fill(a: jnp.ndarray, s: int, fill) -> jnp.ndarray:
    if s > 0:
        return jnp.concatenate([jnp.full((s,), fill, a.dtype), a[:-s]])
    if s < 0:
        return jnp.concatenate([a[-s:], jnp.full((-s,), fill, a.dtype)])
    return a


def compute_row_windows(
    disp_coarse: jnp.ndarray,
    factor: int,
    num_disp: int,
    min_disp: int,
    win_disp: int,
    tile_rows: int = TILE_ROWS,
    smooth_rows: int = 2,
    q_lo: float = 0.25,
    q_hi: float = 0.75,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-tile window starts from a coarse disparity map.

    disp_coarse: (H/factor, W/factor) float disparity in coarse pixel
    units (0 = invalid).  Returns (wstart_tiles, coverage, offband):
    wstart_tiles (H // tile_rows,) int32 window starts in full-res
    disparity units, clipped to [min_disp, min_disp + num_disp - win_disp];
    coverage is the fraction of coarse-valid pixels whose upsampled
    disparity falls inside their row window; offband is the fraction of
    coarse-valid pixels that are outside their window AND spatially
    coherent (all 4-neighbors also outside) — scattered wrong coarse
    matches erode away, while a real off-band object (boat, buoy,
    breaking-wave face — which the reference's always-full-range search
    never misses, wass_stereo.cpp:742-744) survives the erosion and
    should trigger a full-range fallback in production
    (DenseStereoPipeline).

    The per-row bounds are *robust* (interquartile band of the valid
    population, centered): wrong coarse matches must not drag the window
    off the true disparity band.  On the 3 MP bench scene the left-border
    unmatched region alone contaminates ~10% of each row with junk small
    disparities, which pulled raw min/max windows to ~50% coverage; the
    true within-row spread (waves) is a few pixels, so quartile centering
    leaves ~win_disp/2 of margin on each side.
    """
    Hc, Wc = disp_coarse.shape
    assert tile_rows % factor == 0 or factor % tile_rows == 0
    cpt = max(1, tile_rows // factor)  # coarse rows per full-res tile
    n_tiles = (Hc * factor) // tile_rows
    assert n_tiles * cpt == Hc, "image height must tile evenly"

    BIGF = jnp.float32(1e9)
    valid = disp_coarse > 0
    dfull = disp_coarse * factor
    # Per-row quantiles of the valid population: sort with invalids pushed
    # to +inf, then index at rank round(q * n_valid).
    srt = jnp.sort(jnp.where(valid, dfull, BIGF), axis=1)
    nv = jnp.sum(valid, axis=1)
    lo_idx = jnp.clip((nv * q_lo).astype(jnp.int32), 0, Wc - 1)
    hi_idx = jnp.clip((nv * q_hi).astype(jnp.int32), 0, jnp.maximum(nv - 1, 0))
    rmin0 = jnp.take_along_axis(srt, lo_idx[:, None], axis=1)[:, 0]
    rmax0 = jnp.take_along_axis(srt, hi_idx[:, None], axis=1)[:, 0]
    rmin0 = jnp.where(nv > 0, rmin0, BIGF)
    rmax0 = jnp.where(nv > 0, rmax0, -BIGF)

    shifts = [s for s in range(-smooth_rows, smooth_rows + 1) if s]
    rmin = functools.reduce(
        jnp.minimum, [rmin0] + [_shift_fill(rmin0, s, BIGF) for s in shifts]
    )
    rmax = functools.reduce(
        jnp.maximum, [rmax0] + [_shift_fill(rmax0, s, -BIGF) for s in shifts]
    )

    # Rows with no coarse evidence inherit the global valid range (or the
    # full search range when the whole coarse map is empty).
    gmin = jnp.min(jnp.where(rmin < BIGF / 2, rmin, BIGF))
    gmax = jnp.max(jnp.where(rmax > -BIGF / 2, rmax, -BIGF))
    gmin = jnp.where(gmin < BIGF / 2, gmin, jnp.float32(min_disp))
    gmax = jnp.where(gmax > -BIGF / 2, gmax, jnp.float32(min_disp + num_disp - 1))
    rmin = jnp.where(rmin < BIGF / 2, rmin, gmin)
    rmax = jnp.where(rmax > -BIGF / 2, rmax, gmax)

    wmin = jnp.min(rmin.reshape(n_tiles, cpt), axis=1)
    wmax = jnp.max(rmax.reshape(n_tiles, cpt), axis=1)
    center = 0.5 * (wmin + wmax)
    wstart = jnp.round(center - win_disp / 2.0).astype(jnp.int32)
    wstart = jnp.clip(wstart, min_disp, min_disp + num_disp - win_disp)

    # Coverage diagnostics.  Pixels in the left-border triangle — full-res
    # column x smaller than the row's disparity band — can never match at
    # their true disparity (the reference patches their cost to max for
    # the same reason), so the coarse pass fills them with coherent junk
    # values; they are excluded from the metrics, or every clean oblique
    # sea scene would read ~10% "off-band".
    tile_of_row = jnp.arange(Hc, dtype=jnp.int32) // cpt
    ws_c = wstart[tile_of_row].astype(jnp.float32)[:, None]
    inside = (dfull >= ws_c) & (dfull <= ws_c + (win_disp - 1))
    xfull = (jnp.arange(Wc, dtype=jnp.float32) + 0.5) * factor
    reachable = xfull[None, :] >= rmax[:, None]
    considered = valid & reachable
    ncons = jnp.maximum(jnp.sum(considered), 1)
    coverage = jnp.sum(inside & considered) / ncons
    # Spatially-coherent off-band fraction: erode the outside-window mask
    # by its 4-neighborhood so isolated wrong matches vanish but any
    # off-band *object* patch survives.
    out = (~inside) & considered
    coh = out
    for ax, s in ((0, 1), (0, -1), (1, 1), (1, -1)):
        shifted = jnp.roll(out, s, axis=ax)
        # Border rows/cols keep their own value (roll wraps).
        idx = jax.lax.broadcasted_iota(jnp.int32, out.shape, ax)
        edge = idx == (0 if s == 1 else out.shape[ax] - 1)
        coh = coh & (shifted | edge)
    offband = jnp.sum(coh) / ncons
    return wstart, coverage, offband


def wta_disparity_windowed(
    agg: jnp.ndarray, off_rows: jnp.ndarray, uniqueness_ratio: int = 1
) -> jnp.ndarray:
    """WTA over a windowed volume: lane j of row y means true disparity
    off_rows[y] + j.  Runs the standard WTA with a +1 sentinel offset so
    the 0 = invalid marker survives the per-row shift."""
    d = wta_disparity(agg, min_disp=1, uniqueness_ratio=uniqueness_ratio, lr_max_diff=-1)
    return jnp.where(d == 0.0, 0.0, d - 1.0 + off_rows[:, None].astype(jnp.float32))


def c2f_supported(
    H: int, W: int, num_disp: int, win_disp: int, factor: int, directions: int,
    lr_max_diff: int = -1,
) -> bool:
    """Static-shape conformance: the coarse pass pools factor x factor
    blocks, each window covers TILE_ROWS full-res rows (a whole number of
    coarse rows), and the windowed WTA has no left-right check."""
    return (
        0 < win_disp < num_disp
        and TILE_ROWS % factor == 0
        and H % TILE_ROWS == 0
        and W % factor == 0
        and directions in (2, 4, 5, 8)
        and lr_max_diff < 0
    )


def coarse_num_disp(num_disp: int, factor: int) -> int:
    """Coarse search range covering num_disp / factor, rounded up to a
    multiple of 8."""
    n = -(-num_disp // factor)
    return -(-n // 8) * 8


def sgm_disparity_c2f(
    base_img: jnp.ndarray,
    match_img: jnp.ndarray,
    num_disp: int,
    min_disp: int = 1,
    P1: int = 8,
    P2: int = 96,
    directions: int = 8,
    census_win: Tuple[int, int] = (7, 9),
    uniqueness_ratio: int = 1,
    factor: int = 4,
    win_disp: int = 128,
    input_smooth_sigma: float = 0.0,
) -> jnp.ndarray:
    """End-to-end coarse-to-fine disparity (monolithic-jit variant; the
    production CLI uses the fine-grained jit pieces in stereo/dense.py)."""
    H, W = base_img.shape
    assert c2f_supported(H, W, num_disp, win_disp, factor, directions)

    bc = downsample_pool(base_img, factor)
    mc = downsample_pool(match_img, factor)
    disp_c = sgm_disparity(
        bc,
        mc,
        num_disp=coarse_num_disp(num_disp, factor),
        min_disp=max(1, min_disp // factor),
        P1=P1,
        P2=P2,
        directions=directions if directions != 5 else 8,
        census_win=census_win,
        uniqueness_ratio=uniqueness_ratio,
    )
    wstart, _cov, _offband = compute_row_windows(
        disp_c, factor, num_disp, min_disp, win_disp
    )
    return sgm_disparity_windowed(
        base_img, match_img, wstart, win_disp, P1, P2, directions,
        census_win, uniqueness_ratio, input_smooth_sigma,
    )


def sgm_disparity_windowed(
    base_img: jnp.ndarray,
    match_img: jnp.ndarray,
    wstart: jnp.ndarray,
    win_disp: int,
    P1: int = 8,
    P2: int = 96,
    directions: int = 8,
    census_win: Tuple[int, int] = (7, 9),
    uniqueness_ratio: int = 1,
    input_smooth_sigma: float = 0.0,
) -> jnp.ndarray:
    """Full-resolution disparity searched only inside the per-tile windows
    [wstart[t], wstart[t] + win_disp) (census -> windowed cost -> SGM ->
    windowed WTA)."""
    off_rows = jnp.repeat(wstart.astype(jnp.int32), TILE_ROWS)
    cb = census_transform(base_img, census_win, input_smooth_sigma)
    cm = census_transform(match_img, census_win, input_smooth_sigma)
    cost = census_cost_volume(cb, cm, win_disp, offsets=off_rows)
    agg = aggregate(cost, P1, P2, directions, off_rows)
    return wta_disparity_windowed(agg, off_rows, uniqueness_ratio)
