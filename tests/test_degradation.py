"""Input-degradation estimator + AUTO pre-smoothing policy
(wass_tpu/prepare/degradation.py).

The policy encodes the measured robustness map (bench/robustness.py):
clean -> 0.8, sensor noise -> 1.5, deep JPEG -> 2.5 for the matcher.
These tests pin the discrimination itself on synthetic textured imagery.
"""
import io

import numpy as np
import pytest

from wass_tpu.prepare.degradation import (
    DegradationEstimate,
    auto_smooth_sigma,
    classify,
    estimate_degradation,
    resolve_smooth_sigma,
)


def _texture(seed=0, H=512, W=640):
    """Multi-scale wave-like texture: large swell + fine surface detail
    (the fine scale is what JPEG quantizes into visible blocking; an
    overly smooth image compresses near-losslessly at any quality, and
    the estimator correctly reads it as clean)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    coarse = gaussian_filter(rng.standard_normal((H, W)), 6.0)
    fine = gaussian_filter(rng.standard_normal((H, W)), 1.5)
    # Low contrast on purpose: real sea-surface imagery measures
    # mean |d(img)| ~ 0.4 gray levels (the canonical robustness scene);
    # these amplitudes reproduce that, which is exactly the regime where
    # JPEG blocking dominates the interior gradients.
    img = (128 + 15 * coarse / np.abs(coarse).max()
           + 3 * fine / np.abs(fine).max())
    return np.clip(img, 0, 255)


def _jpeg(img, quality):
    import imageio.v3 as iio

    buf = io.BytesIO()
    iio.imwrite(buf, np.clip(img, 0, 255).astype(np.uint8),
                extension=".jpg", quality=quality)
    return iio.imread(buf.getvalue()).astype(np.float64)


class TestEstimator:
    def test_clean_reads_clean(self):
        est = estimate_degradation(_texture())
        assert est.noise_sigma < 0.5
        assert est.blockiness < 1.5
        assert classify(est) == "clean"

    @pytest.mark.parametrize("sigma", [2.0, 3.0, 8.0])
    def test_noise_sigma_accuracy(self, sigma):
        rng = np.random.default_rng(1)
        img = _texture() + rng.standard_normal((512, 640)) * sigma
        est = estimate_degradation(np.clip(img, 0, 255))
        assert abs(est.noise_sigma - sigma) < 0.3 * sigma

    def test_jpeg_blockiness_monotone(self):
        img = _texture()
        b = [estimate_degradation(_jpeg(img, q)).blockiness
             for q in (95, 85, 70)]
        assert b[0] < b[1] < b[2]

    def test_blockiness_crop_offset_invariant(self):
        """The phase scan must find the block grid at any crop offset."""
        img = _jpeg(_texture(H=600, W=720), 75)
        full = estimate_degradation(img).blockiness
        shifted = estimate_degradation(img[3:, 5:]).blockiness
        assert shifted > 0.8 * full > 1.0

    def test_deep_jpeg_classified(self):
        est = estimate_degradation(_jpeg(_texture(), 75))
        assert classify(est) == "jpeg"

    def test_noise_wins_over_blockiness(self):
        """Noisy input later JPEG'd at high quality keeps noise class."""
        rng = np.random.default_rng(2)
        img = np.clip(_texture() + rng.standard_normal((512, 640)) * 4.0, 0, 255)
        est = estimate_degradation(_jpeg(img, 98))
        assert classify(est) in ("noise", "noise_heavy")


class TestPolicy:
    def test_sigma_map(self):
        assert auto_smooth_sigma(DegradationEstimate(0.1, 1.0), "match") == 0.8
        assert auto_smooth_sigma(DegradationEstimate(3.0, 1.0), "match") == 1.5
        assert auto_smooth_sigma(DegradationEstimate(0.2, 3.0), "match") == 2.5
        assert auto_smooth_sigma(DegradationEstimate(0.2, 3.0), "dense") == 0.8
        assert auto_smooth_sigma(DegradationEstimate(3.0, 1.0), "dense") == 1.5

    def test_resolve_explicit_passthrough(self):
        img = _texture()
        assert resolve_smooth_sigma(0.0, img) == 0.0
        assert resolve_smooth_sigma(1.7, img) == 1.7

    def test_resolve_auto(self):
        assert resolve_smooth_sigma(-1.0, _texture(), "match") == 0.8
        assert resolve_smooth_sigma(-1.0, _jpeg(_texture(), 75), "match") == 2.5
