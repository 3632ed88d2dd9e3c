"""Coarse-to-fine windowed SGM: the windowed cost volume and aggregation
(per-row offsets on the plain cost/SGM reference) + e2e.

The windowed volume must degenerate to the full-range one when the window
covers the whole search range, and the full coarse-to-fine path must
reproduce full-range SGM disparities on a scene whose disparity fits the
per-row windows.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from wass_tpu.stereo.cost import census_transform, census_cost_volume
from wass_tpu.stereo.sgm import sgm_aggregate, sgm_disparity, wta_disparity
from wass_tpu.stereo.c2f import (
    TILE_ROWS,
    compute_row_windows,
    sgm_disparity_c2f,
    sgm_disparity_windowed,
    wta_disparity_windowed,
)


def _pair_with_row_disparity(rng, H, W, drow):
    """match = random texture; base[y, x] = match[y, x - drow[y]]."""
    m = rng.uniform(0, 255, (H, W)).astype(np.float32)
    b = np.zeros_like(m)
    for y in range(H):
        d = int(drow[y])
        b[y, d:] = m[y, : W - d]
        b[y, :d] = m[y, :d][::-1]
    return jnp.asarray(b), jnp.asarray(m)


def test_windowed_cost_full_window_identity(rng):
    H, W, D = 16, 64, 16
    b = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    m = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    cb = census_transform(b, (5, 5))
    cm = census_transform(m, (5, 5))
    full = census_cost_volume(cb, cm, D, min_disp=1)
    offsets = jnp.full((H,), 1, jnp.int32)
    win = census_cost_volume(cb, cm, D, offsets=offsets)
    np.testing.assert_array_equal(np.asarray(win), np.asarray(full))


def test_windowed_cost_shifted_tiles(rng):
    """Each windowed lane j must equal the full-volume lane at
    wstart[tile] + j - min_disp."""
    H, W, D, Dw = 16, 64, 24, 8
    b = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    m = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    cb = census_transform(b, (5, 5))
    cm = census_transform(m, (5, 5))
    min_disp = 1
    full = np.asarray(census_cost_volume(cb, cm, D, min_disp=min_disp))
    off_rows = jnp.repeat(jnp.asarray([3, 9], jnp.int32), TILE_ROWS)
    win = np.asarray(census_cost_volume(cb, cm, Dw, offsets=off_rows))
    for t, ws in enumerate([3, 9]):
        rows = slice(t * TILE_ROWS, (t + 1) * TILE_ROWS)
        np.testing.assert_array_equal(
            win[rows], full[rows, :, ws - min_disp : ws - min_disp + Dw]
        )


def test_windowed_aggregate_constant_offsets(rng):
    """With a constant window start the carry never realigns, so the
    windowed aggregation must match the full aggregation exactly."""
    H, W, D = 16, 32, 16
    cost = jnp.asarray(rng.integers(0, 60, (H, W, D)).astype(np.uint8))
    offsets = jnp.full((H,), 5, jnp.int32)
    for dirs in (2, 5, 8):
        ref = sgm_aggregate(cost, 8, 96, dirs)
        win = sgm_aggregate(cost, 8, 96, dirs, offsets)
        np.testing.assert_array_equal(np.asarray(win), np.asarray(ref))


def test_windowed_aggregate_winner_parity_across_tiles(rng):
    """Varying window starts: plant a low-cost band at a row-dependent
    disparity; the windowed aggregation must pick the same winner as the
    full aggregation wherever the band is inside the window."""
    H, W, D, Dw = 32, 32, 32, 16
    drow = 10 + 2 * (np.arange(H) // TILE_ROWS)  # 10, 12, 14, 16
    cost = np.full((H, W, D), 50, np.uint8)
    noise = rng.integers(0, 6, (H, W, D)).astype(np.uint8)
    cost = cost + noise
    for y in range(H):
        cost[y, :, drow[y]] = 2
    cost = jnp.asarray(cost)
    wstart = jnp.asarray(drow[::TILE_ROWS] - Dw // 2, jnp.int32)
    off_rows = jnp.repeat(wstart, TILE_ROWS)

    full = np.asarray(sgm_aggregate(cost, 8, 96, 8)).argmin(-1)
    # Window the cost volume on the host.
    win_cost = np.stack(
        [np.asarray(cost)[y, :, o : o + Dw] for y, o in enumerate(np.asarray(off_rows))]
    )
    win = sgm_aggregate(jnp.asarray(win_cost), 8, 96, 8, off_rows)
    win_d = np.asarray(win).argmin(-1) + np.asarray(off_rows)[:, None]
    np.testing.assert_array_equal(win_d, full)


def test_fused_windowed_wta_matches_unfused(rng):
    """The windowed disparity stage (sgm_disparity_windowed) must reproduce
    wta_disparity_windowed(sgm_aggregate(windowed cost, offsets)) bit-exactly,
    including across varying per-tile window starts."""
    H, W, Dw = 32, 48, 16
    b = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    m = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    wstart = jnp.asarray([3, 9, 5, 12], jnp.int32)
    off_rows = jnp.repeat(wstart, TILE_ROWS)
    cb = census_transform(b, (5, 5))
    cm = census_transform(m, (5, 5))
    cost = census_cost_volume(cb, cm, Dw, offsets=off_rows)
    for dirs in (5, 8):
        agg = sgm_aggregate(cost, 8, 96, dirs, off_rows)
        ref = np.asarray(wta_disparity_windowed(agg, off_rows, uniqueness_ratio=1))
        got = np.asarray(
            sgm_disparity_windowed(b, m, wstart, Dw, 8, 96, dirs, (5, 5), 1)
        )
        np.testing.assert_array_equal(got, ref)


def test_compute_row_windows_fallbacks():
    Hc, Wc = 16, 8
    factor, D, Dw = 4, 64, 16
    disp_c = np.zeros((Hc, Wc), np.float32)
    disp_c[4:8, :] = 3.0  # rows 4-7 see coarse disparity 3 => full-res 12
    ws, cov, offb = compute_row_windows(
        jnp.asarray(disp_c), factor, D, min_disp=1, win_disp=Dw
    )
    ws = np.asarray(ws)
    assert ws.shape == (Hc * factor // TILE_ROWS,)
    assert float(cov) == 1.0
    assert float(offb) == 0.0
    assert np.all(ws >= 1) and np.all(ws <= 1 + D - Dw)
    # Tiles covering coarse rows 4-7 center the window on 12.
    covered = ws[[2, 3]]  # full rows 16..31 <- coarse rows 4..7
    assert np.all(np.abs(covered + Dw // 2 - 12) <= 1)
    # All-invalid map: global fallback still yields in-range windows.
    ws2, _, _ = compute_row_windows(
        jnp.zeros((Hc, Wc)), factor, D, min_disp=1, win_disp=Dw
    )
    ws2 = np.asarray(ws2)
    assert np.all(ws2 >= 1) and np.all(ws2 <= 1 + D - Dw)


def test_offband_object_triggers_fallback():
    """Adversarial case: a compact object (buoy/boat
    patch) at a disparity far outside its row's band must raise the
    coherent off-band metric and trip the production fallback decision,
    while scattered single-pixel junk must not."""
    from wass_tpu.stereo.dense import DenseStereoConfig, c2f_should_fallback

    Hc, Wc = 32, 40
    factor, D, Dw = 4, 64, 16
    rng = np.random.default_rng(0)
    base = 8.0 + 0.5 * rng.standard_normal((Hc, Wc))  # tight row band
    cfg = DenseStereoConfig(num_disp=D, c2f_window=Dw, c2f_factor=factor)

    # 1. Clean scene: no fallback.
    _, cov, offb = compute_row_windows(
        jnp.asarray(base, jnp.float32), factor, D, min_disp=1, win_disp=Dw
    )
    assert not c2f_should_fallback(float(cov), float(offb), cfg)

    # 2. Scattered junk (isolated wrong matches, ~2% of pixels): erosion
    # kills it -> still no fallback.
    junk = base.copy()
    ys = rng.integers(0, Hc, 25)
    xs = rng.integers(0, Wc, 25)
    junk[ys, xs] = 14.9  # full-res 59.6, far outside any Dw=16 window
    _, cov_j, offb_j = compute_row_windows(
        jnp.asarray(junk, jnp.float32), factor, D, min_disp=1, win_disp=Dw
    )
    assert float(offb_j) <= float(cfg.c2f_max_offband)
    assert not c2f_should_fallback(float(cov_j), float(offb_j), cfg)

    # 3. A coherent object patch at an off-band disparity: fallback.
    buoy = base.copy()
    buoy[10:14, 20:25] = 14.9
    _, cov_b, offb_b = compute_row_windows(
        jnp.asarray(buoy, jnp.float32), factor, D, min_disp=1, win_disp=Dw
    )
    assert float(offb_b) > float(cfg.c2f_max_offband)
    assert c2f_should_fallback(float(cov_b), float(offb_b), cfg)


def test_c2f_disparity_end_to_end(rng):
    """Full c2f path (windowed cost + SGM) vs full-range SGM on a
    row-dependent-disparity scene."""
    H, W = 64, 128
    D, Dw, factor = 32, 16, 4
    drow = 6 + (np.arange(H) * 8) // H  # 6..13, within each 8-row tile +-1
    b, m = _pair_with_row_disparity(rng, H, W, drow)

    full = np.asarray(sgm_disparity(b, m, num_disp=D, min_disp=1))
    c2f = np.asarray(
        sgm_disparity_c2f(b, m, num_disp=D, min_disp=1, factor=factor, win_disp=Dw)
    )
    interior = np.zeros((H, W), bool)
    interior[4:-4, 24:-4] = True
    both = (full > 0) & (c2f > 0) & interior
    assert both.mean() > 0.5
    agree = np.abs(full - c2f)[both] <= 1.0
    assert agree.mean() > 0.95
    # And the c2f result actually recovers the planted disparity.
    err = np.abs(c2f - drow[:, None])[(c2f > 0) & interior]
    assert np.median(err) < 0.5


def test_wta_windowed_invalid_marker():
    H, W, Dw = 8, 16, 8
    agg = jnp.ones((H, W, Dw), jnp.int16) * 10
    agg = agg.at[:, :, 3].set(0)
    off = jnp.full((H,), 5, jnp.int32)
    d = np.asarray(wta_disparity_windowed(agg, off, uniqueness_ratio=1))
    # Unique winner at lane 3 -> disparity 8 everywhere (interior lanes).
    assert np.all(d == 8.0)


def test_deferred_fallback_resolution():
    """resolve_fallback (the writer-thread side of deferred c2f
    speculation): device-scalar diagnostics below the coverage guard must
    trigger a full-range re-run matching the full-range pipeline; healthy
    diagnostics must pass the speculative result through untouched."""
    import dataclasses

    from wass_tpu.stereo.dense import (
        DenseStereoConfig, DenseStereoPipeline, build_geom_pack,
        prepare_frame_geometry, rectify_on_device,
    )
    from wass_tpu.testing import make_scene

    h, w = 64, 96
    sc = make_scene(seed=5, width=w, height=h, wave_amplitude=0.25)
    rig = sc.rig
    cfg = DenseStereoConfig(
        num_disp=32, min_disp=1, c2f_window=16, c2f_factor=2,
        plane_ransac_rounds=64, plane_ransac_threshold=0.1,
        plane_max_distance=0.3,
    )
    geom = prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (w, h))
    gp = build_geom_pack(geom, (h, w))
    b_img, m_img = (sc.img0, sc.img1) if geom.base_is_cam0 else (sc.img1, sc.img0)
    b = jnp.asarray(np.asarray(b_img), jnp.float32)
    m = jnp.asarray(np.asarray(m_img), jnp.float32)
    br = rectify_on_device(b, geom.H_base, (h, w))
    mr = rectify_on_device(m, geom.H_match, (h, w))

    pipe = DenseStereoPipeline(cfg, defer_c2f_fallback=True)
    res = pipe(br, mr, b, m, gp)  # speculative windowed result

    # Healthy diagnostics (device scalars, unresolved): pass-through.
    ok_info = {"coverage": jnp.float32(0.97), "offband": jnp.float32(1e-5),
               "fallback": None}
    res_ok, info_ok = pipe.resolve_fallback(res, ok_info, br, mr, b, m, gp)
    assert info_ok["fallback"] is False
    assert res_ok is res

    # Tripped coverage guard: full-range re-run, matching the reference
    # full-range pipeline bit-for-bit.
    bad_info = {"coverage": jnp.float32(0.2), "offband": jnp.float32(1e-5),
                "fallback": None}
    res_fb, info_fb = pipe.resolve_fallback(res, bad_info, br, mr, b, m, gp)
    assert info_fb["fallback"] is True
    full = DenseStereoPipeline(dataclasses.replace(cfg, c2f_window=0))
    ref = full(br, mr, b, m, gp)
    assert int(res_fb.n_points) == int(ref.n_points)
    np.testing.assert_allclose(
        np.asarray(res_fb.plane), np.asarray(ref.plane), atol=1e-6
    )
