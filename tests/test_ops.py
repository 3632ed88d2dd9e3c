"""Tests for image ops: sampling/undistort/warp/resize, morphology, components.

cv2 serves as an independent oracle for OpenCV-compatible behavior.
"""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from wass_tpu.ops import (
    bilinear_sample,
    bicubic_sample,
    warp_homography,
    undistort_image,
    distort_points,
    undistort_points,
    resize,
    dilate_zero,
    erode_zero,
    median_filter,
)
from wass_tpu.ops.components import biggest_component_mask, label_components, zgap_component_mask


def smooth_image(rng, h=64, w=96):
    img = rng.random((h, w)).astype(np.float32)
    return cv2.GaussianBlur(img, (0, 0), 3) * 255.0


class TestSampling:
    def test_bilinear_identity(self, rng):
        img = smooth_image(rng)
        h, w = img.shape
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        out = bilinear_sample(jnp.asarray(img), jnp.asarray(xx), jnp.asarray(yy))
        np.testing.assert_allclose(np.asarray(out), img, atol=1e-4)

    def test_bilinear_matches_cv2_remap(self, rng):
        img = smooth_image(rng)
        h, w = img.shape
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        mapx = (xx * 0.9 + 3.7).astype(np.float32)
        mapy = (yy * 0.93 + 1.2).astype(np.float32)
        ref = cv2.remap(img, mapx, mapy, cv2.INTER_LINEAR)
        out = bilinear_sample(jnp.asarray(img), jnp.asarray(mapx), jnp.asarray(mapy))
        # Interior only (border handling differs).
        np.testing.assert_allclose(np.asarray(out)[2:-2, 2:-2], ref[2:-2, 2:-2], atol=1e-2)

    def test_bicubic_matches_cv2_remap(self, rng):
        img = smooth_image(rng)
        h, w = img.shape
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        mapx = (xx * 0.9 + 2.31).astype(np.float32)
        mapy = (yy * 0.95 + 1.17).astype(np.float32)
        ref = cv2.remap(img, mapx, mapy, cv2.INTER_CUBIC)
        out = bicubic_sample(jnp.asarray(img), jnp.asarray(mapx), jnp.asarray(mapy))
        np.testing.assert_allclose(np.asarray(out)[3:-3, 3:-3], ref[3:-3, 3:-3], atol=0.05)

    def test_warp_homography_matches_cv2(self, rng):
        img = smooth_image(rng)
        h, w = img.shape
        H = np.array([[1.02, 0.01, -2.0], [-0.015, 0.98, 1.5], [1e-5, -2e-5, 1.0]])
        ref = cv2.warpPerspective(img, H, (w, h), flags=cv2.INTER_LINEAR)
        out = warp_homography(jnp.asarray(img), jnp.asarray(H, jnp.float32), (h, w))
        valid = ref > 0
        diff = np.abs(np.asarray(out) - ref)[5:-5, 5:-5]
        assert np.median(diff) < 0.1

    def test_undistort_matches_cv2(self, rng):
        img = smooth_image(rng, 120, 160)
        K = np.array([[150.0, 0, 80], [0, 150, 60], [0, 0, 1]])
        dist = np.array([-0.1, 0.02, 1e-3, -5e-4, 0.0])
        ref = cv2.undistort(img, K, dist)
        out = undistort_image(jnp.asarray(img), jnp.asarray(K, jnp.float32), jnp.asarray(dist, jnp.float32))
        diff = np.abs(np.asarray(out) - ref)[8:-8, 8:-8]
        assert np.median(diff) < 0.15

    def test_distort_undistort_roundtrip(self, rng):
        K = np.array([[800.0, 0, 640], [0, 800, 480], [0, 0, 1]])
        dist = np.array([-0.2, 0.05, 1e-3, -2e-3, 0.01])
        pts = np.stack([rng.uniform(100, 1180, 50), rng.uniform(100, 860, 50)], axis=1)
        d = distort_points(jnp.asarray(pts, jnp.float32), jnp.asarray(K, jnp.float32), jnp.asarray(dist, jnp.float32))
        u = undistort_points(d, jnp.asarray(K, jnp.float32), jnp.asarray(dist, jnp.float32))
        np.testing.assert_allclose(np.asarray(u), pts, atol=0.1)

    def test_undistort_points_matches_cv2(self, rng):
        K = np.array([[800.0, 0, 640], [0, 800, 480], [0, 0, 1]])
        dist = np.array([-0.2, 0.05, 1e-3, -2e-3, 0.01])
        pts = np.stack([rng.uniform(100, 1180, 30), rng.uniform(100, 860, 30)], axis=1)
        ref = cv2.undistortPoints(pts.reshape(-1, 1, 2), K, dist, P=K).reshape(-1, 2)
        out = undistort_points(jnp.asarray(pts, jnp.float32), jnp.asarray(K, jnp.float32), jnp.asarray(dist, jnp.float32))
        np.testing.assert_allclose(np.asarray(out), ref, atol=0.05)

    def test_resize_linear_matches_cv2(self, rng):
        img = smooth_image(rng)
        ref = cv2.resize(img, (48, 32), interpolation=cv2.INTER_LINEAR)
        out = resize(jnp.asarray(img), (32, 48), interp="linear")
        np.testing.assert_allclose(np.asarray(out)[1:-1, 1:-1], ref[1:-1, 1:-1], atol=0.5)

    def test_resize_cubic_upscale(self, rng):
        img = smooth_image(rng, 32, 48)
        ref = cv2.resize(img, (96, 64), interpolation=cv2.INTER_CUBIC)
        out = resize(jnp.asarray(img), (64, 96), interp="cubic")
        np.testing.assert_allclose(np.asarray(out)[2:-2, 2:-2], ref[2:-2, 2:-2], atol=0.5)


class TestMorphology:
    def _ref_dilate_zero(self, src):
        out = src.copy()
        H, W = src.shape
        for i in range(1, H - 1):
            for j in range(1, W - 1):
                if out[i, j] == 0:
                    neigh = [src[a, b] for a in (i - 1, i, i + 1) for b in (j - 1, j, j + 1) if (a, b) != (i, j)]
                    vals = [v for v in neigh if v > 0]
                    if len(vals) > 1:
                        out[i, j] = np.float32(sum(vals) / len(vals))
        return out

    def _ref_erode_zero(self, src):
        out = src.copy()
        H, W = src.shape
        out[0, :] = 0
        out[-1, :] = 0
        out[:, 0] = 0
        out[:, -1] = 0
        for i in range(1, H - 1):
            for j in range(1, W - 1):
                neigh = [src[a, b] for a in (i - 1, i, i + 1) for b in (j - 1, j, j + 1) if (a, b) != (i, j)]
                if any(v == 0 for v in neigh):
                    out[i, j] = 0
        return out

    def test_dilate_zero_matches_reference(self, rng):
        x = (rng.random((20, 24)) > 0.4).astype(np.float32) * rng.uniform(1, 10, (20, 24)).astype(np.float32)
        out = np.asarray(dilate_zero(jnp.asarray(x)))
        ref = self._ref_dilate_zero(x)
        np.testing.assert_allclose(out, ref, atol=1e-4)

    def test_erode_zero_matches_reference(self, rng):
        x = (rng.random((20, 24)) > 0.3).astype(np.float32) * rng.uniform(1, 10, (20, 24)).astype(np.float32)
        out = np.asarray(erode_zero(jnp.asarray(x)))
        ref = self._ref_erode_zero(x)
        np.testing.assert_allclose(out, ref, atol=1e-4)

    def test_median_matches_cv2(self, rng):
        x = rng.random((32, 40)).astype(np.float32)
        ref = cv2.medianBlur(x, 3)
        out = np.asarray(median_filter(jnp.asarray(x), 3))
        np.testing.assert_allclose(out[1:-1, 1:-1], ref[1:-1, 1:-1], atol=1e-6)


class TestComponents:
    def test_biggest_component_matches_cv2(self, rng):
        mask = (rng.random((48, 64)) > 0.55).astype(np.uint8)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(mask, connectivity=4)
        if n > 1:
            areas = stats[1:, cv2.CC_STAT_AREA]
            best = 1 + int(np.argmax(areas))
            ref = labels == best
            out = np.asarray(biggest_component_mask(jnp.asarray(mask.astype(bool))))
            assert out.sum() == ref.sum()
            # The largest component is unique with overwhelming probability on
            # random masks; require exact agreement.
            np.testing.assert_array_equal(out, ref)

    def test_label_components_equivalence_classes(self, rng):
        mask = (rng.random((30, 30)) > 0.5)
        labels = np.asarray(label_components(jnp.asarray(mask)))
        n, ref_labels = cv2.connectedComponents(mask.astype(np.uint8), connectivity=4)
        # Same partition: mapping ref label -> our label must be a bijection.
        pairs = {}
        for a, b in zip(ref_labels[mask].ravel(), labels[mask].ravel()):
            assert pairs.setdefault(a, b) == b
        assert len(set(pairs.values())) == len(pairs)

    def test_zgap_gating_splits_cliff(self):
        z = np.zeros((10, 10), np.float32)
        z[:, 5:] = 100.0  # cliff
        valid = np.ones((10, 10), bool)
        valid[:, :2] = False  # make right side bigger
        mask = np.asarray(zgap_component_mask(jnp.asarray(z), jnp.asarray(valid), jnp.float32(1.0)))
        assert mask[:, 5:].all()
        assert not mask[:, 2:5].any()


def _speckle_mask():
    return np.random.default_rng(42).random((64, 128)) > 0.6  # 40% speckle


def _snake_mask():
    # Serpentine path: worst case for propagation round counts.
    H, W = 40, 96
    mask = np.zeros((H, W), bool)
    for r in range(0, H, 4):
        mask[r, :] = True
        if (r // 4) % 2 == 0:
            mask[r : r + 4, W - 1] = True
        else:
            mask[r : r + 4, 0] = True
    return mask


@pytest.mark.parametrize("make_mask", [_speckle_mask, _snake_mask], ids=["speckle", "snake"])
def test_label_components_matches_scipy(make_mask):
    """label_components at its production round count partitions the mask
    exactly like scipy.ndimage.label (4-connectivity)."""
    from scipy import ndimage

    mask = make_mask()
    labels = np.asarray(label_components(jnp.asarray(mask)))
    ref, n = ndimage.label(mask)
    assert (labels[~mask] == np.iinfo(np.int32).max).all()
    pairs = {}
    for a, b in zip(ref[mask].ravel(), labels[mask].ravel()):
        assert pairs.setdefault(a, b) == b
    assert len(set(pairs.values())) == len(pairs) == n


class TestRectifyWarp:
    def _H_rot(self, deg, w, h):
        c = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
        return np.vstack([c, [0, 0, 1]]).astype(np.float64)

    def test_rectify_is_the_jitted_gather_warp(self, rng):
        """rectify_on_device takes the host homography and runs the same
        bilinear gather warp, compiled once per shape."""
        from wass_tpu.stereo.dense import rectify_on_device

        img = jnp.asarray(smooth_image(rng, 96, 128))
        for deg in (2.5, -1.0):
            Hm = self._H_rot(deg, 128, 96)
            ref = np.asarray(warp_homography(img, jnp.asarray(Hm, jnp.float32), (96, 128)))
            out = np.asarray(rectify_on_device(img, Hm, (96, 128)))
            np.testing.assert_allclose(out, ref, atol=1e-4)

    def test_degenerate_homography_no_nan(self, rng):
        """A homography whose projective denominator vanishes inside the
        image (the line u*g == a) must still warp to finite values."""
        from wass_tpu.stereo.dense import rectify_on_device

        img = smooth_image(rng, 64, 96)
        Hm = self._H_rot(1.0, 96, 64)
        Hmi = np.linalg.inv(Hm)
        # Force a = 48 * g so the degenerate column u = a/g = 48 is in-image.
        Hmi[2, 0] = Hmi[0, 0] / 48.0
        Hm = np.linalg.inv(Hmi)
        out = np.asarray(rectify_on_device(jnp.asarray(img), Hm, (64, 96)))
        assert np.isfinite(out).all()


class TestFlowMorphologyBorders:
    def test_no_wraparound(self):
        from wass_tpu.stereo.flow import binary_dilate, binary_erode

        m = np.zeros((16, 24), np.float32)
        m[-1, 10] = 1.0  # bottom-row seed
        d = np.asarray(binary_dilate(jnp.asarray(m), 1))
        assert d[0].sum() == 0  # must not dilate into the top row
        assert d[-2, 9:12].all()

        m2 = np.ones((16, 24), np.float32)
        m2[0, :] = 0.0  # top row empty
        e = np.asarray(binary_erode(jnp.asarray(m2), 1))
        assert e[-1].all()  # bottom row must not erode via wraparound
        assert not e[1].any()
