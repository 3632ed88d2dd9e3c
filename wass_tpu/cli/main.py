"""wass_tpu command-line interface (the wasscli equivalent).

The reference CLI (/root/reference/cli/wasscli/wasscli.py) is an
interactive menu that shells out to four executables.  Here the stages are
in-process library calls; the CLI exposes them as subcommands (prepare,
match, autocalibrate, stereo, measure) plus `genconfig` reproducing the
--genconfig contract.

    python -m wass_tpu.cli.main <command> [arguments]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


class CliError(Exception):
    """A user-facing failure: printed as `error: ...`, exit status 1."""


def _echo(msg: str) -> None:
    print(msg, flush=True)


def _existing(path: str) -> str:
    if not Path(path).exists():
        raise argparse.ArgumentTypeError(f"path {path!r} does not exist")
    return path


def _load_pipeline(outdir):
    """Build the pipeline, loading any `{prepare,matcher,stereo}_config.txt`
    found in the sequence dir (the reference loads its config file at every
    stage startup, wass_stereo.cpp:1836-1856 / wass_match.cpp:148-169)."""
    from wass_tpu.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu.cli.options import (
        flow_config_from_registry,
        match_config_from_registry,
        prepare_config_from_registry,
        register_all,
        stereo_config_from_registry,
    )
    from wass_tpu.config import registry

    register_all()
    out = Path(outdir)
    for stage in ("prepare", "matcher", "stereo"):
        reg = registry(stage)
        reg.reset()  # don't leak values across sequences in one process
        cfgfile = out / f"{stage}_config.txt"
        if cfgfile.exists():
            reg.load_file(cfgfile)
    cfg = SequenceConfig(
        prepare=prepare_config_from_registry(),
        match=match_config_from_registry(),
        stereo=stereo_config_from_registry(),
        flow=flow_config_from_registry(),
    )
    return SequencePipeline(outdir, cfg)


def _read_gray(path):
    from wass_tpu.io.png import read_gray

    return read_gray(path).astype(np.float32)


def prepare(cam0_dir, cam1_dir, calibdir, outdir, continue_if_existing=False):
    """Prepare all frame pairs into workdirs (wass_prepare)."""
    from wass_tpu.cli.pipeline import SequencePipeline
    from wass_tpu.io.matrices import load_matrix
    from wass_tpu.utils.progress import progress

    calib = Path(calibdir)
    K0 = load_matrix(calib / "intrinsics_00.xml")
    K1 = load_matrix(calib / "intrinsics_01.xml")
    # Distortion files are optional (wass_prepare.cpp:433-443: "Assuming no
    # distortion" when absent).
    d0 = (load_matrix(calib / "distortion_00.xml").reshape(-1)
          if (calib / "distortion_00.xml").exists() else np.zeros(5))
    d1 = (load_matrix(calib / "distortion_01.xml").reshape(-1)
          if (calib / "distortion_01.xml").exists() else np.zeros(5))
    ext_R = ext_T = None
    if (calib / "ext_R.xml").exists():
        ext_R = load_matrix(calib / "ext_R.xml")
        ext_T = load_matrix(calib / "ext_T.xml")

    f0 = sorted(Path(cam0_dir).glob("*"))
    f1 = sorted(Path(cam1_dir).glob("*"))
    if len(f0) != len(f1):
        raise CliError("camera folders contain different frame counts")

    pipe = SequencePipeline(outdir)
    frames = ((_read_gray(a), _read_gray(b)) for a, b in zip(f0, f1))
    for i, (img0, img1) in enumerate(frames):
        wd_path = pipe.outdir / f"{i:06d}_wd"
        if continue_if_existing and (wd_path / "undistorted" / "00000001.png").exists():
            continue
        from wass_tpu.prepare.prepare import prepare_frame

        prepare_frame(wd_path, img0, img1, K0, d0, K1, d1, pipe.cfg.prepare, ext_R, ext_T)
        progress(i + 1, len(f0))
    _echo(f"prepared {len(f0)} frames into {outdir}")


def match(outdir):
    """Feature-match a random subset of frames (wass_match)."""
    n = _load_pipeline(outdir).match()
    _echo(f"matched {n} frames")


def autocalibrate(outdir):
    """Sequence-wide extrinsic refinement (wass_autocalibrate)."""
    res = _load_pipeline(outdir).autocalibrate()
    if res is None:
        raise CliError("autocalibration failed (no matches?)")
    _echo(
        f"epipolar error {res.epi_med_before:.4f} -> {res.epi_med_after:.4f} px "
        f"({res.n_inliers} inliers, {'accepted' if res.improved else 'kept RANSAC pose'})"
    )


def stereo(outdir):
    """Dense reconstruction of every frame (wass_stereo)."""
    planes = _load_pipeline(outdir).stereo()
    _echo(f"reconstructed {len(planes)} frames")


def measure(workdir, pixels, baseline=None, radius=10.0, interactive=False):
    """Two-point 3D distance on a reconstructed frame.

    The wass_stereo --measure workflow (wass_stereo.cpp:1934-1973): the
    reference pops an interactive PointPicker (PointPicker.hpp:24-189) over
    the stereo pair and reports the distance between two triangulated
    points.  Here the points are given as cam0 pixel coordinates
    `U0 V0 U1 V1` (or clicked via --interactive when a display exists);
    each is snapped to the nearest reconstructed mesh point reprojected
    through K0."""
    from wass_tpu.io.workdir import Workdir
    from wass_tpu.stereo.meshops import measure_distance

    wd = Workdir(Path(workdir))
    if interactive:
        import matplotlib.pyplot as plt

        img = wd.load_undistorted(0)
        fig, ax = plt.subplots()
        ax.imshow(img, cmap="gray")
        ax.set_title("click two points")
        picked = plt.ginput(2, timeout=0)
        plt.close(fig)
        if len(picked) != 2:
            raise CliError("need exactly two clicked points")
        pixels = [c for uv in picked for c in uv]
    if len(pixels) != 4:
        raise CliError("expected 4 coordinates: U0 V0 U1 V1 (or --interactive)")

    mesh = wd.load_mesh_cam()  # (3, N) cam0-frame, baseline units
    if mesh.shape[1] == 0:
        raise CliError("empty mesh_cam.xyzC")
    K0 = wd.load_intrinsics(0)
    uv = (K0 @ mesh)
    uv = uv[:2] / uv[2:3]  # (2, N)

    picked_pts = []
    for (u, v) in ((pixels[0], pixels[1]), (pixels[2], pixels[3])):
        d2 = (uv[0] - u) ** 2 + (uv[1] - v) ** 2
        j = int(np.argmin(d2))
        if d2[j] > radius * radius:
            raise CliError(
                f"no reconstructed point within {radius:g} px of ({u:g}, {v:g})"
            )
        p = mesh[:, j]
        _echo(f"({u:g}, {v:g}) -> point #{j} at "
              f"[{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}] "
              f"(reprojects to {uv[0][j]:.1f}, {uv[1][j]:.1f})")
        picked_pts.append(p)

    dist = float(measure_distance(picked_pts[0], picked_pts[1]))
    _echo(f"distance: {dist:.6f} baseline units")
    if baseline is not None:
        _echo(f"distance: {dist * baseline:.6f} m (baseline {baseline:g} m)")


def genconfig(outdir, stage="stereo"):
    """Dump the commented key=value config of a stage (--genconfig)."""
    from wass_tpu.config import registry
    from wass_tpu.cli.options import register_all

    register_all()
    text = registry(stage).to_config_string()
    out = Path(outdir)
    if out.is_dir():
        out = out / f"{stage}_config.txt"
    out.write_text(text)
    _echo(f"wrote {out}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="wass_tpu",
        description="wass_tpu: sea-wave stereo reconstruction in JAX, on an NVIDIA GPU.",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("prepare", help=prepare.__doc__.splitlines()[0])
    p.add_argument("cam0_dir", type=_existing)
    p.add_argument("cam1_dir", type=_existing)
    p.add_argument("calibdir", type=_existing)
    p.add_argument("outdir")
    p.add_argument("--continue-if-existing", action="store_true")
    p.set_defaults(run=lambda a: prepare(
        a.cam0_dir, a.cam1_dir, a.calibdir, a.outdir, a.continue_if_existing))

    for name, fn in (("match", match), ("autocalibrate", autocalibrate), ("stereo", stereo)):
        p = sub.add_parser(name, help=fn.__doc__.splitlines()[0])
        p.add_argument("outdir", type=_existing)
        p.set_defaults(run=lambda a, fn=fn: fn(a.outdir))

    p = sub.add_parser("measure", help="Two-point 3D distance on a reconstructed frame.")
    p.add_argument("workdir", type=_existing)
    p.add_argument("pixels", nargs="*", type=float)
    p.add_argument("--baseline", type=float, default=None,
                   help="camera baseline in meters; scales the reported distance "
                   "from baseline units to meters")
    p.add_argument("--radius", type=float, default=10.0,
                   help="max pixel distance between a requested pixel and the "
                   "nearest reconstructed point")
    p.add_argument("--interactive", action="store_true",
                   help="pick the two points by clicking on the cam0 image "
                   "(requires a display)")
    p.set_defaults(run=lambda a: measure(
        a.workdir, a.pixels, a.baseline, a.radius, a.interactive))

    p = sub.add_parser("genconfig", help=genconfig.__doc__.splitlines()[0])
    p.add_argument("outdir")
    p.add_argument("--stage", choices=["prepare", "matcher", "stereo"], default="stereo")
    p.set_defaults(run=lambda a: genconfig(a.outdir, a.stage))
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: parse argv, run the command; 0 on success, 1 on a
    user-facing failure (argparse exits with 2 on bad arguments)."""
    from wass_tpu.utils.compile_cache import enable_compile_cache

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    try:
        args.run(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
