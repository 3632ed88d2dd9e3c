"""GPU tier: the CUDA kernel against the plain reference at real widths,
the matmul-precision pins, and the reference's quality gates at bench
scale, as in-repo tests.

Gates (the verify harness of the reference):
* dense elevation: trimmed-mean plane-aligned error < 0.02 baseline
  units (/root/reference/test/verify_meshes.m:26-30);
* matcher: >= 400 matches and <= 0.5 px mean epipolar error at full
  resolution (/root/reference/test/verify_matcher.m:5-8,18-25);
* pose: |dR| <= 5e-3, |dT| <= 2e-2 against ground truth
  (verify_matcher.m:7-8).

Run: WASS_GPU_TESTS=1 python -m pytest tests -m gpu -q
(each test skips without a GPU — see the `gpu` fixture in conftest.py).
chip_smoke.py runs the same checks through wass_tpu.testing.gpu_checks.
"""

import numpy as np
import pytest

from wass_tpu.testing import gpu_checks

pytestmark = pytest.mark.gpu


def _scene(W, H, seed, rig=None):
    from wass_tpu.testing import make_scene

    sc = make_scene(seed=seed, width=W, height=H, wave_amplitude=0.25, rig=rig, on_device=True)
    return sc.img0, sc.img1, sc.points0, sc.rig


@pytest.fixture(scope="module")
def bench_scene_3mp():
    return _scene(2048, 1536, 7)


@pytest.mark.parametrize("windowed", [False, True], ids=["full", "windowed"])
@pytest.mark.parametrize("directions", [8, 5])
@pytest.mark.parametrize("W,H", [(2048, 1536), (2560, 1920)], ids=["3mp", "5mp"])
def test_sgm_kernel_matches_reference(gpu, W, H, directions, windowed):
    r = gpu_checks.check_sgm_kernel(H, W, 640, directions, windowed)
    assert r["sums_equal"] and r["wta_equal"], r


def test_gate_products_pinned(gpu):
    diffs = gpu_checks.precision_checks()
    assert all(d == 0.0 for d in diffs.values()), diffs


def test_dense_gate_3mp(gpu, bench_scene_3mp):
    """One 3 MP frame, GT extrinsics, reference-default D=640: elevation
    gate with margin and a sanity floor on density."""
    from wass_tpu.stereo.dense import DenseStereoConfig, dense_stereo_frame

    img0, img1, points0, rig = bench_scene_3mp
    W, H = 2048, 1536
    cfg = DenseStereoConfig(
        num_disp=640, min_disp=1,
        plane_ransac_threshold=0.1, plane_max_distance=0.3,
    )
    out, _ = dense_stereo_frame(
        img0.astype(np.float32), img1.astype(np.float32),
        rig.K0, rig.K1, rig.R, rig.T, cfg,
    )
    valid = np.asarray(out.valid)
    pts = np.asarray(out.points)[valid]
    plane = np.asarray(out.plane, np.float64)
    assert np.all(np.isfinite(plane)) and bool(out.plane_ok)
    assert len(pts) > 0.3 * W * H, f"density collapsed: {len(pts)}"

    trimmed = gpu_checks.elevation_error(pts, plane, points0, rig.K0, rig.baseline)
    assert trimmed < gpu_checks.ELEVATION_GATE, f"elevation {trimmed:.4f} over the gate"


def test_matcher_gates_fullres(gpu, bench_scene_3mp):
    """Full-resolution matcher gates: >= 400 matches, <= 0.5 px f64 epi
    error, single-pair pose inside the calibration gates."""
    from wass_tpu.match.pipeline import MatchConfig, match_frame

    img0, img1, _, rig = bench_scene_3mp
    res = match_frame(
        img0.astype(np.float64), img1.astype(np.float64),
        rig.K0, rig.K1, MatchConfig(),
    )
    assert res is not None
    assert res.n_matches >= gpu_checks.MIN_MATCHES, f"matches {res.n_matches}"
    assert res.epi_avg <= gpu_checks.MAX_EPI_PX, f"epi {res.epi_avg:.3f} px"
    dR, dT = gpu_checks.pose_errors(res.R, res.T, rig)
    assert dR <= gpu_checks.MAX_DR and dT <= gpu_checks.MAX_DT


@pytest.mark.slow
def test_calibrated_loop_gates(gpu, tmp_path):
    """The no-ground-truth loop at 3 MP-class scale: match 8 frames ->
    pooled autocalibration -> dense stereo with the RECOVERED extrinsics;
    pose and elevation gates asserted end-to-end."""
    from wass_tpu.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu.io.xyzc import load_camera_mesh
    from wass_tpu.match.pipeline import MatchConfig
    from wass_tpu.stereo.dense import DenseStereoConfig
    from wass_tpu.testing import make_rig

    W, H, n_frames = 1536, 1152, 8
    rig = make_rig(width=W, height=H)
    frames, gts = [], []
    for i in range(n_frames):
        img0, img1, points0, rig = _scene(W, H, 900 + i, rig=rig)
        frames.append((img0, img1))
        gts.append(points0)

    root = tmp_path / "loop"
    cfg = SequenceConfig(
        match=MatchConfig(),
        stereo=DenseStereoConfig(num_disp=640, min_disp=1,
                                 plane_ransac_threshold=0.1,
                                 plane_max_distance=0.3),
        debug_renders=False,
    )
    pipe = SequencePipeline(root, cfg)
    pipe.prepare(frames, rig.K0, np.zeros(5), rig.K1, np.zeros(5))
    assert pipe.match() >= 6
    res = pipe.autocalibrate()
    assert res is not None
    dR, dT = gpu_checks.pose_errors(res.R, res.T, rig)
    assert dR <= gpu_checks.MAX_DR and dT <= gpu_checks.MAX_DT

    wds = pipe.workdirs()[:2]
    pipe.stereo(wds)
    for i, wd in enumerate(wds):
        mesh_cam = load_camera_mesh(wd.path / "mesh_cam.xyzC")
        plane = wd.load_plane()
        trimmed = gpu_checks.elevation_error(mesh_cam.T, plane, gts[i], rig.K0, rig.baseline)
        assert trimmed < gpu_checks.ELEVATION_GATE, f"frame {i}: calibrated elevation {trimmed:.4f}"
