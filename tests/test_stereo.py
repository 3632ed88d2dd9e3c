"""Dense-stereo stage tests: cost/SGM on known-disparity stereograms, the
plane fitter on noisy planes, and the full pipeline on a synthetic scene
against the reference's verify_meshes-style elevation gate
(/root/reference/test/verify_meshes.m:26-30, relaxed for the small test
resolution — the full-scale gate runs in the benchmark)."""

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wass_tpu.stereo.cost import census_transform, census_cost_volume
from wass_tpu.stereo.sgm import sgm_aggregate, sgm_disparity, wta_disparity
from wass_tpu.stereo.plane import ransac_find_plane, refine_plane, crop_plane
from wass_tpu.stereo.dense import DenseStereoConfig, dense_stereo_frame
from wass_tpu.testing import make_scene


def shifted_stereogram(rng, h=96, w=160, dmax=24):
    """Random-dot pair with a known smooth disparity field.

    base(y, x) = match(y, x - d(y, x)) per the base/match convention.
    """
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    d = 6 + 5 * np.sin(xx / 37.0) * np.cos(yy / 23.0) + 6 * (yy / h)
    tex = rng.random((h, w + dmax + 8)).astype(np.float32)
    tex = cv2.GaussianBlur(tex, (0, 0), 1.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 220 + 20
    match = tex[:, : w]
    sample_x = (xx - d + dmax + 4)
    base = np.zeros((h, w), np.float32)
    x0 = np.floor(sample_x).astype(int)
    f = (sample_x - x0).astype(np.float32)
    base = tex[yy, x0 - dmax - 4 + dmax + 4] * 0  # init
    base = (1 - f) * tex[yy, x0] + f * tex[yy, x0 + 1]
    # match image must be the unshifted texture at the same coords offset:
    match = tex[:, dmax + 4 : dmax + 4 + w]
    return base.astype(np.float32), match, d.astype(np.float32)


class TestCensusSGM:
    def test_census_shapes(self, rng):
        img = rng.random((32, 48)).astype(np.float32)
        c = census_transform(jnp.asarray(img), (5, 5))
        assert c.shape == (32, 48, 1)
        c2 = census_transform(jnp.asarray(img), (7, 9))
        assert c2.shape == (32, 48, 2)

    def test_cost_volume_zero_at_true_disparity(self, rng):
        base, match, d = shifted_stereogram(rng)
        cb = census_transform(jnp.asarray(base), (5, 5))
        cm = census_transform(jnp.asarray(match), (5, 5))
        vol = np.asarray(census_cost_volume(cb, cm, 24, 0))
        h, w = base.shape
        # At integer-disparity pixels the cost should be near zero.
        ints = np.abs(d - np.round(d)) < 0.05
        ints[:, :30] = False  # stay clear of the border
        ys, xs = np.where(ints)
        costs = vol[ys, xs, np.round(d[ys, xs]).astype(int)]
        assert np.median(costs) <= 2

    def test_sgm_recovers_disparity(self, rng):
        base, match, d = shifted_stereogram(rng)
        disp = np.asarray(
            sgm_disparity(jnp.asarray(base), jnp.asarray(match), num_disp=24, min_disp=0, census_win=(5, 5))
        )
        inner = np.zeros_like(d, bool)
        inner[8:-8, 30:-8] = True
        err = np.abs(disp - d)[inner & (disp > 0)]
        assert np.median(err) < 0.5
        assert (err < 1.0).mean() > 0.9

    def test_sgm_beats_wta(self, rng):
        """Aggregation should beat raw WTA on a weakly textured pair."""
        base, match, d = shifted_stereogram(rng)
        noisy_b = base + rng.standard_normal(base.shape).astype(np.float32) * 12
        noisy_m = match + rng.standard_normal(match.shape).astype(np.float32) * 12
        cb = census_transform(jnp.asarray(noisy_b), (5, 5))
        cm = census_transform(jnp.asarray(noisy_m), (5, 5))
        vol = census_cost_volume(cb, cm, 24, 0)
        raw = np.asarray(jnp.argmin(vol.astype(jnp.int32), -1))
        agg = sgm_aggregate(vol, P1=8, P2=96, directions=8)
        disp = np.asarray(wta_disparity(agg, 0))
        inner = np.zeros_like(d, bool)
        inner[8:-8, 30:-8] = True
        err_raw = np.abs(raw - d)[inner]
        err_sgm = np.abs(disp - d)[inner & (disp > 0)]
        assert np.median(err_sgm) < np.median(err_raw)
        assert (err_sgm < 1).mean() > 0.8


class TestPlane:
    def test_ransac_plane_with_outliers(self, rng):
        H, W = 64, 96
        n = np.array([0.1, 0.85, 0.5])
        n /= np.linalg.norm(n)
        d = -7.5
        xy = rng.uniform(-5, 5, (H, W, 2))
        pts = np.concatenate([xy, ((-d - xy @ n[:2]) / n[2])[..., None]], -1)
        noise = rng.standard_normal((H, W)) * 0.02
        pts += noise[..., None] * n
        out_mask = rng.random((H, W)) < 0.25
        pts[out_mask] += rng.uniform(1, 5, (out_mask.sum(), 1)) * n
        valid = rng.random((H, W)) < 0.9
        fit = ransac_find_plane(jnp.asarray(pts, jnp.float32), jnp.asarray(valid), jax.random.PRNGKey(0), 400, 0.1)
        assert bool(fit.ok)
        est = np.asarray(fit.plane)
        assert abs(np.dot(est[:3], n)) > 0.999
        assert abs(est[3] - d) < 0.05
        # Refinement after cropping should tighten the estimate.
        v2 = np.asarray(crop_plane(fit.plane, jnp.asarray(pts, jnp.float32), jnp.asarray(valid), 0.1))
        ref = np.asarray(refine_plane(jnp.asarray(pts, jnp.float32), jnp.asarray(v2)))
        assert abs(np.dot(ref[:3], n)) > 0.9995


@pytest.mark.slow
class TestDensePipeline:
    def test_end_to_end_synthetic(self):
        sc = make_scene(seed=1, width=384, height=288, wave_amplitude=0.25)
        rig = sc.rig
        # directions=8: at this tiny test resolution (0.1 MP vs the 3-5 MP
        # design point) the extra SGM paths measurably reduce disparity
        # noise; the production default (5, reference parity) is gated at
        # full scale by bench.py's elevation-error report.
        cfg = DenseStereoConfig(
            num_disp=64, min_disp=1, plane_ransac_threshold=0.1, plane_max_distance=0.3,
            directions=8,
        )
        res, geom = dense_stereo_frame(sc.img0, sc.img1, rig.K0, rig.K1, rig.R, rig.T, cfg)
        valid = np.asarray(res.valid)
        pts = np.asarray(res.points)
        # Coverage: most of the frame reconstructs (the density gate scales
        # with resolution; >60% of pixels here).
        assert int(res.n_points) > 0.6 * valid.size
        assert bool(res.plane_ok)
        # Plane accuracy vs ground truth.
        est = np.asarray(res.plane)
        gt = rig.plane_cam0()
        gt_scaled = gt.copy()
        gt_scaled[3] /= rig.baseline
        assert abs(np.dot(est[:3], gt[:3])) > 0.995
        assert abs(est[3] - gt_scaled[3]) < 0.2
        # Elevation accuracy (verify_meshes.m style, trimmed mean), relaxed
        # ~2x for the low test resolution (focal ~420 px vs ~2800 real).
        err = sc.eta_cam0(pts[valid] * rig.baseline) / rig.baseline
        ae = np.sort(np.abs(err))
        trimmed = ae[: int(len(ae) * 0.999)]
        assert trimmed.mean() < 0.04


class TestBurnedGate:
    def test_burned_match_region_invalidates(self):
        """DISCARD_BURNED_AREAS (wass_stereo.cpp:1069-1093): a saturated
        blob in the match image must invalidate base pixels whose
        correspondence lands inside it — exercised through the
        cond + shift-select path (no row gathers)."""
        import dataclasses
        from wass_tpu.stereo.dense import triangulate_dense, build_geom_pack, prepare_frame_geometry

        sc = make_scene(seed=5, width=192, height=144, wave_amplitude=0.2)
        rig = sc.rig
        cfg = DenseStereoConfig(num_disp=32, min_disp=1, directions=4)
        res0, geom = dense_stereo_frame(sc.img0, sc.img1, rig.K0, rig.K1, rig.R, rig.T, cfg)
        n0 = int(res0.n_points)
        assert n0 > 1000
        # Saturate a blob in the match image and rerun.
        m_img = (sc.img1 if geom.base_is_cam0 else sc.img0).copy()
        m_img[60:90, 60:120] = 255.0
        if geom.base_is_cam0:
            res1, _ = dense_stereo_frame(sc.img0, m_img, rig.K0, rig.K1, rig.R, rig.T, cfg)
        else:
            res1, _ = dense_stereo_frame(m_img, sc.img1, rig.K0, rig.K1, rig.R, rig.T, cfg)
        n1 = int(res1.n_points)
        assert n1 < n0, (n0, n1)


_BIG = 32000
_PATHS = {
    2: [(0, 1), (0, -1)],
    4: [(0, 1), (0, -1), (1, 0), (-1, 0)],
    5: [(0, 1), (0, -1), (1, 0), (1, 1), (1, -1)],
    8: [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1), (1, -1), (-1, 1)],
}


def _bruteforce_sgm(cost, P1, P2, directions, offsets=None):
    """Pixel-by-pixel numpy SGM: every path walked in (dy, dx) order with
    the textbook recurrence; windowed volumes realign the predecessor by
    the offset change between rows."""
    H, W, D = cost.shape
    off = np.zeros(H, int) if offsets is None else np.asarray(offsets, int)
    total = np.zeros((H, W, D), np.int64)
    for dy, dx in _PATHS[directions]:
        L = np.zeros((H, W, D), np.int64)
        for y in range(H) if dy >= 0 else range(H - 1, -1, -1):
            for x in range(W) if dx >= 0 else range(W - 1, -1, -1):
                py, px = y - dy, x - dx
                prev = np.full(D, _BIG, np.int64)
                if 0 <= py < H and 0 <= px < W:
                    delta = off[y] - off[py]
                    for j in range(D):
                        if 0 <= j + delta < D:
                            prev[j] = L[py, px, j + delta]
                m = prev.min()
                lo = np.concatenate([[_BIG], prev[:-1]])
                hi = np.concatenate([prev[1:], [_BIG]])
                best = np.minimum(np.minimum(prev, m + P2), np.minimum(lo, hi) + P1)
                L[y, x] = cost[y, x] + best - m
        total += L
    return total


class TestSGMImplementations:
    """The plain reference against a brute-force SGM, and the CPU-visible
    parts of the CUDA route: the wrapper's padding and offsets, the build
    command, and the platform dispatch (no fallback)."""

    @pytest.mark.parametrize("windowed", [False, True], ids=["full", "windowed"])
    @pytest.mark.parametrize("directions", [2, 4, 5, 8])
    def test_reference_matches_bruteforce(self, rng, directions, windowed):
        H, W, D = 9, 11, 6
        cost = rng.integers(0, 65, (H, W, D)).astype(np.uint8)
        offsets = rng.integers(0, 5, H).astype(np.int32) if windowed else None
        got = np.asarray(
            sgm_aggregate(
                jnp.asarray(cost), 8, 96, directions,
                None if offsets is None else jnp.asarray(offsets),
            )
        )
        np.testing.assert_array_equal(got, _bruteforce_sgm(cost, 8, 96, directions, offsets))

    @staticmethod
    def _fake_ffi(monkeypatch):
        """Replace the FFI call with a recorder returning zeros."""
        import wass_tpu.kernels as kernels

        calls = []
        monkeypatch.setattr(kernels, "ensure_registered", lambda: None)

        def ffi_call(name, out_type, **_kw):
            def run(*args, **attrs):
                calls.append((name, out_type, args, attrs))
                return jnp.zeros(out_type.shape, out_type.dtype)

            return run

        monkeypatch.setattr(jax.ffi, "ffi_call", ffi_call)
        return calls

    def test_cuda_wrapper_pads_disparity_axis(self, monkeypatch):
        from wass_tpu.stereo.sgm import sgm_aggregate_cuda

        calls = self._fake_ffi(monkeypatch)
        cost = jnp.ones((6, 10, 7), jnp.uint8)
        out = sgm_aggregate_cuda(cost, 8, 96, 5)
        assert out.shape == (6, 10, 7) and out.dtype == jnp.int16
        name, out_type, (c, off), attrs = calls[0]
        assert name == "wass_sgm_aggregate"
        assert out_type.shape == (6, 10, 8)  # D padded to a multiple of 4
        assert c.shape == (6, 10, 8) and c.dtype == jnp.uint8
        np.testing.assert_array_equal(np.asarray(c[..., 7]), 0)
        np.testing.assert_array_equal(np.asarray(off), np.zeros(6, np.int32))
        assert attrs == dict(num_disp=7, p1=8, p2=96, directions=5, windowed=0)

    def test_cuda_wrapper_passes_offsets(self, monkeypatch):
        from wass_tpu.stereo.sgm import sgm_aggregate_cuda

        calls = self._fake_ffi(monkeypatch)
        cost = jnp.ones((8, 10, 16), jnp.int32)
        offsets = jnp.arange(8, dtype=jnp.int16)
        out = sgm_aggregate_cuda(cost, 4, 64, 8, offsets)
        assert out.shape == (8, 10, 16)
        _, out_type, (c, off), attrs = calls[0]
        assert out_type.shape == (8, 10, 16)  # no padding needed
        assert c.dtype == jnp.uint8
        assert off.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(off), np.arange(8))
        assert attrs["windowed"] == 1 and attrs["p1"] == 4 and attrs["p2"] == 64

    def test_kernel_build_command(self, monkeypatch, tmp_path):
        """The library is built for sm_90a into the ignored build directory,
        and a failed build raises."""
        import subprocess
        import wass_tpu.kernels as kernels

        monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path)
        monkeypatch.setattr(kernels, "_nvcc", lambda: "/fake/cuda/bin/nvcc")
        seen = []

        def fake_run(cmd, **kw):
            seen.append(cmd)
            return subprocess.CompletedProcess(cmd, 1, "", "error: no card")

        monkeypatch.setattr(kernels.subprocess, "run", fake_run)
        with pytest.raises(kernels.KernelBuildError, match="no card"):
            kernels.build()
        cmd = seen[0]
        assert cmd[0] == "/fake/cuda/bin/nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert any(a.endswith("sgm_aggregate.cu") for a in cmd)
        assert str(kernels.library_path().parent) == str(tmp_path)

    def test_dispatch_cpu_uses_reference(self, rng):
        from wass_tpu.stereo.sgm import aggregate

        cost = jnp.asarray(rng.integers(0, 65, (8, 12, 10)).astype(np.uint8))
        offsets = jnp.asarray(rng.integers(0, 4, 8).astype(np.int32))
        np.testing.assert_array_equal(
            np.asarray(aggregate(cost, 8, 96, 8, offsets)),
            np.asarray(sgm_aggregate(cost, 8, 96, 8, offsets)),
        )

    def test_dispatch_gpu_without_library_raises(self, monkeypatch, tmp_path):
        """On a GPU the kernel is the only route: a missing toolchain is an
        error, never a silent fall back to the reference."""
        import wass_tpu.kernels as kernels
        from wass_tpu.stereo.sgm import aggregate

        def no_nvcc():
            raise kernels.KernelBuildError("nvcc not found")

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(kernels, "_registered", False)
        monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path)
        monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
        with pytest.raises(kernels.KernelBuildError):
            aggregate(jnp.zeros((4, 4, 8), jnp.uint8), 8, 96, 8)

    def test_dispatch_unknown_platform_raises(self, monkeypatch):
        from wass_tpu.stereo.sgm import aggregate

        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(RuntimeError, match="rocm"):
            aggregate(jnp.zeros((4, 4, 8), jnp.uint8), 8, 96, 8)


class TestBurnedMaskWrap:
    def test_right_edge_saturation_does_not_wrap(self):
        """jnp.roll wraps, so right-edge saturation in the match
        image invalidated left-edge base pixels where x - d < 0.  The
        column-iota mask must stop that; in-range hits must still fire."""
        from wass_tpu.stereo.dense import burned_match_mask

        H, W = 8, 64
        bm = np.zeros((H, W), bool)
        bm[:, -4:] = True  # saturated at the right edge of the match image
        disp = np.full((H, W), 6.0, np.float32)
        out = np.asarray(burned_match_mask(jnp.asarray(disp), jnp.asarray(bm), 1, 16))
        # Reference: burned iff x - 6 lands in [W-4, W).
        xx = np.arange(W)
        ref = (xx - 6 >= W - 4) & (xx - 6 < W)
        np.testing.assert_array_equal(out, np.broadcast_to(ref, (H, W)))
        assert not out[:, :6].any()  # the wrap region stays clean


class TestDeltaExport:
    def test_delta_payload_roundtrip_exact(self, rng):
        """The delta-coded wire payload must reconstruct the EXACT u16
        quantized points of the direct export (byte-identical .xyzC)."""
        import jax.numpy as jnp

        from wass_tpu.io.xyzc import decode_delta_payload
        from wass_tpu.stereo.dense import _stage_export, _stage_export_delta

        H, W = 40, 56
        # Smooth surface + jumps + invalid holes: exercises small deltas,
        # exception rows (row wrap, discontinuities) and compaction.
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        z = 10.0 + 0.01 * xx + 0.02 * yy + 0.2 * np.sin(xx / 5.0)
        z[yy > 30] += 5.0  # depth discontinuity
        pts = np.stack([(xx - W / 2) * z / 100, (yy - H / 2) * z / 100, z], -1)
        valid = rng.random((H, W)) > 0.25
        plane = np.array([0.01, -0.02, 0.9, -9.5])
        plane[:3] /= np.linalg.norm(plane[:3])

        args = (
            jnp.asarray(pts, jnp.float32), jnp.asarray(valid),
            jnp.asarray(plane, jnp.float32),
        )
        q, mins, scales = _stage_export(*args)
        db, exc, q2, nexc_dev, mins2, scales2 = _stage_export_delta(*args)
        n = int(valid.sum())
        np.testing.assert_array_equal(np.asarray(mins), np.asarray(mins2))
        np.testing.assert_array_equal(np.asarray(q2), np.asarray(q))

        delta_b = np.asarray(db[:n])
        n_exc = int((delta_b[:, 0] == 0).sum())
        assert n_exc == int(nexc_dev)
        assert n_exc >= 1  # point 0 is always an exception
        rec = decode_delta_payload(delta_b, np.asarray(exc[:n_exc]))
        np.testing.assert_array_equal(rec, np.asarray(q[:n]))

    def test_delta_exceptions_rare_at_production_width(self, rng):
        """At production frame widths one pixel step is <= ~32 x-quanta,
        so the delta stream is the cheap one (the whole point of the
        encoding)."""
        import jax.numpy as jnp

        from wass_tpu.stereo.dense import _stage_export_delta

        H, W = 24, 1024
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        z = 10.0 + 0.001 * xx + 0.02 * yy
        pts = np.stack([(xx - W / 2) * z / 1000, (yy - H / 2) * z / 1000, z], -1)
        valid = rng.random((H, W)) > 0.1
        plane = np.array([0.0, 0.0, 1.0, -10.0])
        db, exc, q2, nexc_dev, mins, scales = _stage_export_delta(
            jnp.asarray(pts, jnp.float32), jnp.asarray(valid),
            jnp.asarray(plane, jnp.float32),
        )
        n = int(valid.sum())
        assert int(nexc_dev) < 0.25 * n

    def test_delta_payload_empty(self):
        from wass_tpu.io.xyzc import decode_delta_payload

        out = decode_delta_payload(np.zeros((0, 3), np.uint8), np.zeros((0, 3), np.uint16))
        assert out.shape == (0, 3)
