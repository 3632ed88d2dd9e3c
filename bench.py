#!/usr/bin/env python
"""Benchmark of the dense-stereo pipeline on one NVIDIA GPU.

    python bench.py                    # dense frames/s, 2048x1536, D=640
    python bench.py --size 2560x1920   # the 5 MP reference rig
    python bench.py --e2e              # PNG pair -> .xyzC through SequencePipeline.stereo
    python bench.py --accuracy         # match -> autocalibrate -> stereo, no GT extrinsics

Synthetic wave-field scenes (wass_tpu.testing.make_scene, rendered on the
device from a seed) stand in for camera frames; the reference design point
is 3 MP at MAX_DISPARITY=640 (wass_stereo.cpp:742-744).  Prints one JSON
line naming the device.  Refuses to run without a GPU: a number from the
CPU is not a benchmark of this program.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def _scene(W, H, seed, rig=None):
    from wass_tpu.testing import make_scene

    return make_scene(seed=seed, width=W, height=H, wave_amplitude=0.25, rig=rig, on_device=True)


def _frame_fn(cfg, sc, defer: bool = False):
    """One dense frame from the raw pair: rectify + DenseStereoPipeline."""
    import jax.numpy as jnp

    from wass_tpu.stereo.dense import (
        DenseStereoPipeline, build_geom_pack, prepare_frame_geometry, rectify_on_device,
    )

    rig = sc.rig
    H, W = sc.img0.shape
    geom = prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    b_img, m_img = (sc.img0, sc.img1) if geom.base_is_cam0 else (sc.img1, sc.img0)
    b, m = jnp.asarray(b_img), jnp.asarray(m_img)
    gp = build_geom_pack(geom, (H, W))
    pipe = DenseStereoPipeline(cfg, defer_c2f_fallback=defer)

    def frame():
        br = rectify_on_device(b, geom.H_base, (H, W))
        mr = rectify_on_device(m, geom.H_match, (H, W))
        return pipe(br, mr, b, m, gp)

    return frame, pipe


def _time_frames(frame, n: int):
    """(median, min, max) seconds per frame, each ending in a host fetch of
    the frame's point count (the pipeline's last dependency)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        int(frame().n_points)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), float(min(times)), float(max(times))


def bench_dense(W, H, D, n_frames, dev):
    from wass_tpu.stereo.dense import DenseStereoConfig
    from wass_tpu.testing.gpu_checks import ELEVATION_GATE, elevation_error

    sc = _scene(W, H, 7)
    cfg = DenseStereoConfig(num_disp=D, min_disp=1, plane_ransac_threshold=0.1,
                            plane_max_distance=0.3)
    frame, pipe = _frame_fn(cfg, sc)
    t0 = time.time()
    res = frame()
    print(f"# compile + first frame {time.time() - t0:.1f} s; c2f {pipe.last_c2f}",
          file=sys.stderr)
    valid = np.asarray(res.valid)
    pts = np.asarray(res.points)[valid]
    err = elevation_error(pts, np.asarray(res.plane), sc.points0, sc.rig.K0, sc.rig.baseline)
    if not (bool(res.plane_ok) and err < ELEVATION_GATE):
        sys.exit(f"quality gate failed: plane_ok={bool(res.plane_ok)} elevation {err:.5f}")
    med, lo, hi = _time_frames(frame, n_frames)
    return {
        "metric": f"dense_frames_per_s_{W}x{H}_D{D}", "value": 1.0 / med, "unit": "frames/s",
        "frame_s_median": med, "frame_s_min": lo, "frame_s_max": hi, "frames": n_frames,
        "n_points": int(res.n_points), "elevation_err": err, "device": dev,
    }


def bench_e2e(W, H, D, n_frames, dev):
    """PNG decode -> rectify -> dense -> .xyzC export through
    SequencePipeline.stereo, the path a user runs."""
    import tempfile
    from pathlib import Path

    from wass_tpu.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu.stereo.dense import DenseStereoConfig

    sc = _scene(W, H, 7)
    rig = sc.rig
    with tempfile.TemporaryDirectory(prefix="wass_bench_") as tmp:
        cfg = SequenceConfig(
            stereo=DenseStereoConfig(num_disp=D, min_disp=1, plane_ransac_threshold=0.1,
                                     plane_max_distance=0.3),
            debug_renders=False,
        )
        pipe = SequencePipeline(Path(tmp), cfg)
        pipe.prepare([(sc.img0, sc.img1)] * n_frames, rig.K0, np.zeros(5), rig.K1,
                     np.zeros(5), ext_R=rig.R, ext_T=rig.T)
        wds = pipe.workdirs()
        t0 = time.time()
        pipe.stereo(wds[:2])
        print(f"# warm-up (2 frames, incl. compilation) {time.time() - t0:.1f} s",
              file=sys.stderr)
        t0 = time.time()
        planes = pipe.stereo(wds)
        dt = (time.time() - t0) / n_frames
        n_ok = sum(1 for p in planes if np.all(np.isfinite(p)))
        if n_ok != n_frames or not (wds[-1].path / "mesh_cam.xyzC").exists():
            sys.exit(f"e2e run failed: {n_ok}/{n_frames} planes")
    return {"metric": f"e2e_png_to_xyzc_frames_per_s_{W}x{H}_D{D}", "value": 1.0 / dt,
            "unit": "frames/s", "frames": n_frames, "wire_delta": pipe.cfg.wire_delta,
            "device": dev}


def bench_accuracy(W, H, D, n_frames, dev):
    """match -> autocalibrate (sequence BA) -> stereo with the recovered
    extrinsics; elevation error against ground truth (no GT extrinsics)."""
    import tempfile
    from pathlib import Path

    from wass_tpu.cli.pipeline import SequenceConfig, SequencePipeline
    from wass_tpu.match.pipeline import MatchConfig
    from wass_tpu.stereo.dense import DenseStereoConfig
    from wass_tpu.testing import make_rig
    from wass_tpu.testing.gpu_checks import elevation_error, pose_errors

    rig = make_rig(width=W, height=H)
    scenes = [_scene(W, H, 900 + i, rig=rig) for i in range(n_frames)]
    with tempfile.TemporaryDirectory(prefix="wass_bench_") as tmp:
        cfg = SequenceConfig(
            match=MatchConfig(),
            stereo=DenseStereoConfig(num_disp=D, min_disp=1, plane_ransac_threshold=0.1,
                                     plane_max_distance=0.3),
            debug_renders=False,
        )
        pipe = SequencePipeline(Path(tmp), cfg)
        pipe.prepare([(s.img0, s.img1) for s in scenes], rig.K0, np.zeros(5), rig.K1, np.zeros(5))
        n_ok = pipe.match()
        res = pipe.autocalibrate()
        if res is None:
            sys.exit("autocalibration failed")
        dR, dT = pose_errors(res.R, res.T, rig)
        wds = pipe.workdirs()[:2]
        pipe.stereo(wds)
        errs = [
            elevation_error(wd.load_mesh_cam().T, wd.load_plane(), s.points0, rig.K0, rig.baseline)
            for wd, s in zip(wds, scenes)
        ]
    return {"metric": f"calibrated_elevation_err_{W}x{H}_{n_frames}f", "value": max(errs),
            "unit": "baseline_units", "matched_frames": n_ok, "pose_dR": dR, "pose_dT": dT,
            "device": dev}


def main():
    ap = argparse.ArgumentParser(description="dense-stereo benchmark on one GPU")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--e2e", action="store_true")
    mode.add_argument("--accuracy", action="store_true")
    ap.add_argument("--size", default=None, help="WxH (default 2048x1536; 1536x1152 for --accuracy)")
    ap.add_argument("--num-disp", type=int, default=640)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()

    dev = _device()
    from wass_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    size = args.size or ("1536x1152" if args.accuracy else "2048x1536")
    W, H = (int(v) for v in size.lower().split("x"))
    fn = bench_e2e if args.e2e else bench_accuracy if args.accuracy else bench_dense
    print(json.dumps(fn(W, H, args.num_disp, args.frames, dev)))


if __name__ == "__main__":
    main()
