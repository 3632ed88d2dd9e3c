"""Full-pipeline integration test (the test_pipeline.m equivalent,
/root/reference/test/test_pipeline.m): synthetic multi-frame sequence ->
prepare -> match -> autocalibrate -> stereo -> gridded outputs, asserting
the reference's verification gates at test scale."""

import numpy as np
import pytest

from wass_tpu.testing import make_scene, make_rig
from wass_tpu.cli.pipeline import SequencePipeline, SequenceConfig
from wass_tpu.match.pipeline import MatchConfig
from wass_tpu.stereo.dense import DenseStereoConfig
from wass_tpu.io.xyzc import load_camera_mesh


class TestShardedExportParity:
    def test_sharded_xyzc_matches_pipelined(self, tmp_path):
        """The sharded path must export through the SAME device-side
        quantize+compact route as the pipelined path: equivalent .xyzC
        artifacts (point count, decoded cloud statistics), not a re-upload
        of host-fetched f32 grids (round-3 regression: cli/pipeline.py
        fetched every result leaf per frame)."""
        from wass_tpu.io.xyzc import load_camera_mesh

        W, H, F = 96, 64, 4
        rig = make_rig(width=W, height=H)
        scenes = [
            make_scene(seed=300 + i, width=W, height=H, wave_amplitude=0.25,
                       rig=rig, time=i * 0.25)
            for i in range(F)
        ]
        cfg = SequenceConfig(
            stereo=DenseStereoConfig(num_disp=16, min_disp=1,
                                     plane_ransac_rounds=64,
                                     plane_ransac_threshold=0.1,
                                     plane_max_distance=0.3),
            debug_renders=False,
        )
        pipe = SequencePipeline(tmp_path / "seq", cfg)
        zeros = np.zeros(5)
        wds = pipe.prepare(
            [(s.img0, s.img1) for s in scenes], rig.K0, zeros, rig.K1, zeros,
            ext_R=rig.R, ext_T=rig.T,
        )

        planes_sh = pipe._stereo_sharded(wds)
        sharded = [
            (wd.path / "mesh_cam.xyzC").read_bytes() for wd in wds
        ]
        planes_pl = pipe._stereo_pipelined(wds)
        for i, wd in enumerate(wds):
            np.testing.assert_allclose(planes_sh[i], planes_pl[i], atol=5e-4)
            mesh_pl = load_camera_mesh(wd.path / "mesh_cam.xyzC")
            (wd.path / "mesh_sh.xyzC").write_bytes(sharded[i])
            mesh_sh = load_camera_mesh(wd.path / "mesh_sh.xyzC")
            # Same compaction order, same quantization contract; point
            # counts may differ by a handful (different XLA partitioning).
            n_pl, n_sh = mesh_pl.shape[1], mesh_sh.shape[1]
            assert abs(n_pl - n_sh) <= max(16, 0.01 * n_pl)
            n = min(n_pl, n_sh)
            assert n > 0.3 * W * H
            # Decoded clouds agree pointwise up to quantization + the
            # plane-fit tolerance.
            d = np.abs(mesh_pl[:, :n] - mesh_sh[:, :n])
            assert np.quantile(d, 0.99) < 0.05


@pytest.mark.slow
class TestSequencePipeline:
    def test_full_pipeline(self, tmp_path):
        W, H = 384, 288
        # 6 frames: two-view pose from <=3 pooled frames at 0.1 MP is
        # genuinely ambiguous (two BA basins with equal reprojection cost,
        # dR swinging 8e-4 <-> 1.5e-2 on 1-ulp input noise); 6 frames
        # (~1000 pooled matches) pin it to dR ~ 7e-5 stably.
        n_frames = 6
        rng = np.random.default_rng(11)
        rig = make_rig(width=W, height=H)
        scenes = [
            make_scene(seed=100 + i, width=W, height=H, wave_amplitude=0.25, rig=rig, time=i * 0.2)
            for i in range(n_frames)
        ]

        cfg = SequenceConfig(
            match=MatchConfig(num_features=1200, iidyn_iters=6000, max_rounds=8,
                              hessian_threshold=3e-5, feature_grid_cell=8),
            stereo=DenseStereoConfig(num_disp=64, min_disp=1,
                                     plane_ransac_threshold=0.1, plane_max_distance=0.3),
        )
        pipe = SequencePipeline(tmp_path / "seq", cfg)

        # Prepare (no distortion in the synthetic rig).
        zeros = np.zeros(5)
        wds = pipe.prepare(
            [(s.img0, s.img1) for s in scenes], rig.K0, zeros, rig.K1, zeros
        )
        assert len(wds) == n_frames
        for wd in wds:
            assert wd.undistorted_path(0).exists()
            assert wd.undistorted_path(1).exists()

        # Match.
        n_ok = pipe.match()
        assert n_ok >= 2
        assert (wds[0].path / "wass_match_log.txt").exists()

        # Autocalibrate: pooled reduction must improve/maintain accuracy.
        res = pipe.autocalibrate()
        assert res is not None
        assert (tmp_path / "seq" / "wass_autocalibrate_log.txt").exists()
        Tg = rig.T / np.linalg.norm(rig.T)
        # Calibration gates (verify_matcher.m:7-8): the reference's own
        # full-scale bounds (5e-3 / 2e-2).  At this tiny 0.1 MP test
        # resolution the T view-axis component is genuinely
        # resolution-limited (~1.6e-2 across estimator variants; the
        # quasi-planar scene barely constrains it at f ~ 420 px), while
        # at the production 1.77-3 MP scale the same estimator measures
        # dR ~ 1.1e-4 / dT ~ 2e-4 (bench.py --accuracy, 50-100x inside
        # the gates) — the scale where the gate is defined.
        assert np.abs(res.R - rig.R).max() < 5e-3
        assert np.abs(res.T.ravel() - Tg).max() < 2e-2
        # The refined pose must actually be broadcast to every workdir
        # (reference writes unconditionally, wass_autocalibrate.cpp:366-377;
        # a round-3 bug gated this on BA-beats-init and left the stereo
        # stage consuming the inferior per-frame match poses).
        for wd in wds:
            np.testing.assert_allclose(wd.load_extrinsics()[0], res.R, atol=1e-12)

        # Stereo on all frames.
        planes = pipe.stereo()
        assert len(planes) == n_frames
        assert (tmp_path / "seq" / "output" / "planes.txt").exists()

        # Per-frame point clouds decode through the byte-exact reader and
        # meet the elevation gate (verify_meshes.m style, relaxed for
        # resolution).
        for i, wd in enumerate(pipe.workdirs()):
            mesh_cam = load_camera_mesh(wd.path / "mesh_cam.xyzC")  # (3, N)
            assert mesh_cam.shape[1] > 0.3 * W * H
            plane = wd.load_plane()
            err = scenes[i].elevation_error(mesh_cam.T, plane)
            ae = np.sort(np.abs(err[np.isfinite(err)]))
            trimmed = ae[: int(len(ae) * 0.999)]
            # verify_meshes.m gate is 0.02 at 3 MP; at this 0.1 MP test
            # resolution the dense match is quantization/resolution-limited
            # to ~0.025 even with GT extrinsics — gate at 0.04 (~1.5x
            # margin over the calibrated measurement).  The full-scale
            # calibrated gate is checked by bench.py --accuracy and the
            # gpu tier (test_gpu_gates.py).
            assert trimmed.mean() < 0.04
            # Failure-map artifact (wass_stereo.cpp:1114-1119 equivalent).
            assert (wd.path / "triangulation_failmap.jpg").exists()


class TestWireDeltaAuto:
    def test_break_even_flips(self):
        """The AUTO wire decision must pick delta on slow-link/fast-host
        and direct on fast-link/slow-host (the break-even rule)."""
        from wass_tpu.cli.pipeline import SequencePipeline

        d = SequencePipeline._wire_delta_decision
        # A host decoding 4e-7 s/pt behind a 28 MB/s link: the link ships
        # the saved 1.5 B/pt in 5.1e-8 s -> direct wins.
        assert d(28.0, 4e-7) is False
        # A 1 MB/s link: 1.4e-6 s/pt on the wire -> delta wins.
        assert d(1.0, 4e-7) is True
        # A PCIe-class host link (2 GB/s): delta is always moot.
        assert d(2000.0, 1e-7) is False

    def test_probe_returns_bool_and_resolves(self, tmp_path):
        from wass_tpu.cli.pipeline import SequencePipeline

        got = SequencePipeline._probe_wire_delta()
        assert got in (True, False)
