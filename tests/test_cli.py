"""CLI integration tests: the full WASS workflow through the console
entry points — pipeline workdirs -> gridsurface setup/grid -> post
spectrum — on a small synthetic sequence (test_pipeline.m territory, but
driven through the same commands a user would run)."""

import numpy as np
import pytest
from click.testing import CliRunner

from wass_tpu.testing import make_scene, make_rig


@pytest.fixture(scope="module")
def reconstructed_seq(tmp_path_factory):
    """A small sequence taken through prepare+stereo with known extrinsics
    (the ext_R/ext_T passthrough path, so no matching is needed)."""
    from wass_tpu.cli.pipeline import SequencePipeline, SequenceConfig
    from wass_tpu.stereo.dense import DenseStereoConfig

    out = tmp_path_factory.mktemp("seq")
    W, H = 256, 192
    rng = np.random.default_rng(5)
    rig = make_rig(width=W, height=H)
    scenes = [
        make_scene(seed=200 + i, width=W, height=H, wave_amplitude=0.25, rig=rig, time=i * 0.25)
        for i in range(4)
    ]
    cfg = SequenceConfig(
        stereo=DenseStereoConfig(num_disp=64, min_disp=1, plane_ransac_threshold=0.1, plane_max_distance=0.3)
    )
    pipe = SequencePipeline(out, cfg)
    zeros = np.zeros(5)
    pipe.prepare([(s.img0, s.img1) for s in scenes], rig.K0, zeros, rig.K1, zeros,
                 ext_R=rig.R, ext_T=rig.T)
    pipe.stereo()
    return out, rig


class TestGridsurfaceCLI:
    def test_setup_and_grid(self, reconstructed_seq, tmp_path):
        from wass_tpu.cli.gridsurface import cli

        seq, rig = reconstructed_seq
        outdir = tmp_path / "grid"
        runner = CliRunner()
        r = runner.invoke(cli, [str(seq), str(outdir), "--action", "setup",
                                "--baseline", str(rig.baseline),
                                "--area_center", "0,-20", "--area_size", "16",
                                "-N", "64", "--fps", "4"])
        assert r.exit_code == 0, r.output
        assert (outdir / "config.mat").exists()

        r = runner.invoke(cli, [str(seq), str(outdir), "--action", "grid",
                                "--algorithm", "IDW"])
        assert r.exit_code == 0, r.output
        assert (outdir / "gridded.nc").exists()

        # The cube holds all frames with sane elevations (meters scale).
        import h5py

        with h5py.File(outdir / "gridded.nc") as f:
            Z = f["Z"][...]
            assert Z.shape[0] == 4
            finite = np.isfinite(Z)
            assert finite.mean() > 0.2
            assert np.nanstd(Z[finite]) < 2000.0  # mm

    def test_post_spectrum_on_cube(self, reconstructed_seq, tmp_path):
        from wass_tpu.cli.gridsurface import cli as gcli
        from wass_tpu.cli.post import cli as pcli

        seq, rig = reconstructed_seq
        outdir = tmp_path / "grid2"
        runner = CliRunner()
        r = runner.invoke(gcli, [str(seq), str(outdir), "--action", "setup",
                                 "--baseline", str(rig.baseline),
                                 "--area_center", "0,-20", "--area_size", "16",
                                 "-N", "48", "--fps", "4"])
        assert r.exit_code == 0, r.output
        r = runner.invoke(gcli, [str(seq), str(outdir), "--action", "grid", "--algorithm", "IDW"])
        assert r.exit_code == 0, r.output

        nc = str(outdir / "gridded.nc")
        r = runner.invoke(pcli, ["info", nc])
        assert r.exit_code == 0 and "Z:" in r.output

        r = runner.invoke(pcli, ["spectrum", nc, "--nperseg", "4", "--rangespan", "1"])
        assert r.exit_code == 0, r.output
        assert "Hm0" in r.output

        r = runner.invoke(pcli, ["setfps", nc, "5.0"])
        assert r.exit_code == 0
        r = runner.invoke(pcli, ["zeromean", nc])
        assert r.exit_code == 0


@pytest.fixture
def no_compile_cache(monkeypatch):
    """The CLI entry turns on JAX's persistent compile cache; keep the test
    process's compilations out of it."""
    import wass_tpu.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda: "")


@pytest.mark.usefixtures("no_compile_cache")
class TestMainCLI:
    def test_measure(self, reconstructed_seq, capsys):
        """The wass_stereo --measure equivalent: distance between two
        reconstructed points addressed by cam0 pixel coordinates."""
        from wass_tpu.cli.main import main
        from wass_tpu.io.workdir import Workdir

        seq, _rig = reconstructed_seq
        wd = Workdir(sorted(seq.glob("*_wd"))[0])
        mesh = wd.load_mesh_cam()
        K0 = wd.load_intrinsics(0)
        uv = K0 @ mesh
        uv = uv[:2] / uv[2:3]
        i, j = 10, mesh.shape[1] - 10
        expected = float(np.linalg.norm(mesh[:, i] - mesh[:, j]))
        rc = main([
            "measure", str(wd.path),
            f"{uv[0][i]:.2f}", f"{uv[1][i]:.2f}", f"{uv[0][j]:.2f}", f"{uv[1][j]:.2f}",
            "--baseline", "2.5",
        ])
        out = capsys.readouterr().out
        assert rc == 0, out
        got = float(out.split("distance: ")[1].split()[0])
        assert abs(got - expected) < 5e-2 * max(expected, 1.0)
        assert f"{expected * 2.5:.3f}"[:5] in out or "m (baseline" in out

    def test_measure_rejects_far_pixel(self, reconstructed_seq, capsys):
        from wass_tpu.cli.main import main

        seq, _rig = reconstructed_seq
        wd = sorted(seq.glob("*_wd"))[0]
        rc = main(["measure", str(wd), "1e6", "1e6", "0", "0"])
        assert rc != 0
        assert "no reconstructed point" in capsys.readouterr().err

    def test_genconfig(self, tmp_path, capsys):
        from wass_tpu.cli.main import main

        rc = main(["genconfig", str(tmp_path), "--stage", "stereo"])
        assert rc == 0, capsys.readouterr().err
        text = (tmp_path / "stereo_config.txt").read_text()
        # Reference option names & genconfig format (matcher.html.md:36-96).
        assert "MAX_DISPARITY=640" in text
        assert text.count("#") > 20


@pytest.mark.parametrize("shape", [(37, 53), (64, 80, 3)], ids=["gray", "rgb"])
def test_png_codec_roundtrip(tmp_path, shape):
    """The numpy + zlib PNG codec reads what libpng (native) or imageio
    writes, and they read what it writes."""
    from wass_tpu import native
    from wass_tpu.io import png

    img = (np.random.default_rng(3).random(shape) * 255).astype(np.uint8)
    ext = tmp_path / "ext.png"
    if len(shape) == 2 and native.available():
        native.png_write_gray(ext, img)
    else:
        import imageio.v3 as iio

        iio.imwrite(ext, img)
    np.testing.assert_array_equal(png.decode(ext.read_bytes()), img)
    if len(shape) == 2:
        ours = tmp_path / "ours.png"
        ours.write_bytes(png.encode_gray(img))
        if native.available():
            np.testing.assert_array_equal(native.png_read_gray(ours), img)
        import imageio.v3 as iio

        np.testing.assert_array_equal(iio.imread(ours), img)


class TestCompileCache:
    def test_env_var_left_to_jax(self, monkeypatch, tmp_path):
        import jax

        from wass_tpu.utils.compile_cache import enable_compile_cache

        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        assert enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_default_is_checkout_dir(self, monkeypatch):
        from pathlib import Path

        import jax

        import wass_tpu
        from wass_tpu.utils.compile_cache import enable_compile_cache

        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
        expected = str(Path(wass_tpu.__file__).resolve().parents[1] / ".jax_cache")
        assert enable_compile_cache() == expected
        assert calls == [("jax_compilation_cache_dir", expected)]
