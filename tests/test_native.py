"""Native C++ runtime tests: PNG/JPEG IO, xyzC codec parity with the pure
Python implementation, and the threaded prefetcher."""

import numpy as np
import pytest

from wass_tpu import native
from wass_tpu.io.xyzc import load_camera_mesh, save_xyz_compressed

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib unavailable")


class TestImageIO:
    def test_png_roundtrip(self, tmp_path, rng):
        img = (rng.random((64, 96)) * 255).astype(np.uint8)
        p = tmp_path / "a.png"
        native.png_write_gray(p, img)
        back = native.png_read_gray(p)
        np.testing.assert_array_equal(back, img)

    def test_png_interop_with_imageio(self, tmp_path, rng):
        import imageio.v3 as iio

        img = (rng.random((48, 80)) * 255).astype(np.uint8)
        p = tmp_path / "b.png"
        native.png_write_gray(p, img)
        np.testing.assert_array_equal(iio.imread(p), img)
        p2 = tmp_path / "c.png"
        iio.imwrite(p2, img)
        np.testing.assert_array_equal(native.png_read_gray(p2), img)

    def test_jpeg_encode(self, rng):
        img = (rng.random((64, 64)) * 255).astype(np.uint8)
        data = native.jpeg_encode(img, quality=95)
        assert data[:2] == b"\xff\xd8"  # JPEG SOI
        import imageio.v3 as iio

        dec = iio.imread(data)
        assert dec.shape[:2] == (64, 64)


class TestXyzc:
    def test_codec_matches_python(self, tmp_path, rng):
        n = 5000
        pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        mask = (rng.random(n) > 0.3).astype(np.uint8)
        Rpl = np.eye(3)
        Tpl = np.array([0.1, -0.2, 4.0])
        Rinv = Rpl.T
        Tinv = -Rpl.T @ Tpl

        p_native = tmp_path / "native.xyzC"
        native.xyzc_write(p_native, pts, mask, Rpl, Tpl, Rinv, Tinv)

        # Python reference writer on the same compacted, transformed data.
        sel = pts[mask.astype(bool)].astype(np.float64)
        plane_pts = sel @ Rpl.T + Tpl
        p_py = tmp_path / "py.xyzC"
        save_xyz_compressed(p_py, plane_pts, Rinv, Tinv)

        a = load_camera_mesh(p_native)
        b = load_camera_mesh(p_py)
        assert a.shape == b.shape
        # Quantization grids are identical => decoded values match closely.
        np.testing.assert_allclose(a, b, atol=1e-3)
        # Decoded points recover the camera-frame originals within the
        # 16-bit quantization step.
        np.testing.assert_allclose(a.T, sel, atol=10.0 / 65535 * 2 + 1e-3)

    def test_native_reader_on_python_file(self, tmp_path, rng):
        pts = rng.uniform(-2, 2, (100, 3))
        Rinv = np.eye(3)
        Tinv = np.zeros(3)
        p = tmp_path / "x.xyzC"
        save_xyz_compressed(p, pts, Rinv, Tinv)
        a = native.xyzc_read(p)
        b = load_camera_mesh(p)
        np.testing.assert_allclose(a, b, atol=1e-12)


class TestPrefetcher:
    def test_parallel_decode(self, tmp_path, rng):
        paths = []
        imgs = []
        for i in range(12):
            img = (rng.random((32, 48)) * 255).astype(np.uint8)
            p = tmp_path / f"{i}.png"
            native.png_write_gray(p, img)
            paths.append(p)
            imgs.append(img)
        pf = native.Prefetcher(n_threads=3)
        tickets = [pf.submit(p) for p in paths]
        for t, img in zip(tickets, imgs):
            np.testing.assert_array_equal(pf.take(t), img)
        pf.close()
