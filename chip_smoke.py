#!/usr/bin/env python3
"""Bring-up check on one NVIDIA GPU: the dense-stereo pipeline end to end.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # the frame-sharded path on four cards

One card, in one process:
  1. the CUDA SGM kernel against the plain JAX reference at 2048x1536 and
     2560x1920 with D=640, 8 and 5 paths, full range and windowed (128):
     equal int16 sums and equal WTA disparities;
  2. every float32 product that feeds a quality gate, under the default
     matmul precision and under "highest": equal (they are pinned);
  3. prepare -> stereo on 4 synthetic 3 MP frame pairs written as PNG, with
     ground-truth extrinsics, through the CLI entry function (D=640, c2f
     on), one more frame at full range (c2f off); every frame must fit a
     plane and pass the 0.02 elevation gate;
  4. prepare -> match -> autocalibrate on the same 4 frames with no
     extrinsics: >= 400 matches at <= 0.5 px per frame, pose within
     |dR| <= 5e-3 and |dT| <= 2e-2.

--four runs only the sharded path: 8 frames (two batches of four, one with
an off-band object that trips the c2f guard) through SequencePipeline.stereo
on a ("frame",) mesh, each compared with the same frame on one device, and
the point-sharded bundle adjustment against the single-device one.

The last line of standard output is one JSON object naming the device; any
failure exits non-zero before it is printed.  Exits non-zero when JAX finds
no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

W3, H3 = 2048, 1536  # 3 MP, the reference design point
W5, H5 = 2560, 1920  # 5 MP, the reference rig
NUM_DISP = 640  # MAX_DISPARITY default (wass_stereo.cpp:742-744)


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)
    log(f"ok: {msg}")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


# ---------------------------------------------------------------- scenes --


def render_frames(n: int, W: int, H: int, seed0: int):
    """n distinct synthetic frame pairs of one rig, rendered on the device."""
    from wass_tpu.testing import make_rig, make_scene

    rig = make_rig(width=W, height=H)
    t0 = time.time()
    scenes = [
        make_scene(seed=seed0 + i, wave_amplitude=0.25, rig=rig, on_device=True)
        for i in range(n)
    ]
    log(f"rendered {n} scenes at {W}x{H} in {time.time() - t0:.1f} s")
    return rig, scenes


def write_sequence(root: Path, rig, pairs, with_extrinsics: bool):
    """cam0/, cam1/ PNG folders and a calib/ folder, as a user has them."""
    from wass_tpu.io.matrices import save_matrix_xml
    from wass_tpu.io.png import write_gray

    for d in ("cam0", "cam1", "calib"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i, (img0, img1) in enumerate(pairs):
        write_gray(root / "cam0" / f"{i:06d}.png", img0)
        write_gray(root / "cam1" / f"{i:06d}.png", img1)
    save_matrix_xml(root / "calib" / "intrinsics_00.xml", "intrinsics", rig.K0)
    save_matrix_xml(root / "calib" / "intrinsics_01.xml", "intrinsics", rig.K1)
    if with_extrinsics:
        save_matrix_xml(root / "calib" / "ext_R.xml", "ext_R", rig.R)
        save_matrix_xml(root / "calib" / "ext_T.xml", "ext_T", rig.T.reshape(3, 1))


def cli(*argv: str) -> None:
    from wass_tpu.cli.main import main

    rc = main([str(a) for a in argv])
    check(rc == 0, f"wass_tpu {argv[0]} exits 0")


def stereo_config(seq: Path) -> None:
    """genconfig, then the plane thresholds of the synthetic scenes (baseline
    units), as a user edits stereo_config.txt."""
    cli("genconfig", seq, "--stage", "stereo")
    path = seq / "stereo_config.txt"
    text = path.read_text()
    for key, val in (("PLANE_RANSAC_THRESHOLD", "0.1"), ("PLANE_MAX_DISTANCE", "0.3")):
        text, n = re.subn(rf"^{key}=.*$", f"{key}={val}", text, flags=re.M)
        check(n == 1, f"stereo_config.txt sets {key}")
    path.write_text(text)


def frame_report(wd):
    """(plane, n_points, c2f line) of a reconstructed workdir."""
    log_text = (wd.path / "wass_stereo_log.txt").read_text()
    n = int(re.search(r"triangulated\+filtered points: (\d+)", log_text).group(1))
    c2f = re.search(r"c2f window coverage.*", log_text)
    return wd.load_plane(), n, c2f.group(0) if c2f else "c2f off"


def elevation_gate(wd, scene, rig, tag: str) -> None:
    from wass_tpu.testing.gpu_checks import ELEVATION_GATE, elevation_error

    plane, n, c2f = frame_report(wd)
    check(bool(np.all(np.isfinite(plane))), f"{tag}: plane fitted ({c2f})")
    mesh = wd.load_mesh_cam()
    err = elevation_error(mesh.T, plane, scene.points0, rig.K0, rig.baseline)
    log(f"{tag}: {n} points, elevation error {err:.5f} baseline units")
    check(err < ELEVATION_GATE, f"{tag}: elevation error {err:.5f} < {ELEVATION_GATE}")


# ---------------------------------------------------------------- phases --


def phase_kernels() -> None:
    from wass_tpu.testing.gpu_checks import check_sgm_kernel

    first = True
    for W, H in ((W3, H3), (W5, H5)):
        for directions in (8, 5):
            for windowed in (False, True):
                r = check_sgm_kernel(H, W, NUM_DISP, directions, windowed, print_memory=first)
                first = False
                log(f"SGM {r}")
                check(r["sums_equal"] and r["wta_equal"],
                      f"kernel == reference at {W}x{H} D={r['D']} {directions} paths"
                      f"{' windowed' if windowed else ''}")


def phase_precision() -> None:
    from wass_tpu.testing.gpu_checks import precision_checks

    diffs = precision_checks()
    log(f"default vs highest matmul precision, max |diff| per stage: {diffs}")
    # Pinned products: any difference means TF32 reached a gate quantity.
    for stage, d in diffs.items():
        check(d == 0.0, f"{stage} is independent of the default matmul precision")


def phase_stereo(work: Path, rig, scenes) -> None:
    from wass_tpu.cli.main import _load_pipeline
    from wass_tpu.cli.pipeline import SequencePipeline
    from wass_tpu.io.workdir import frame_workdirs

    src = work / "frames"
    write_sequence(src, rig, [(s.img0, s.img1) for s in scenes], with_extrinsics=True)
    seq = work / "seq"
    cli("prepare", src / "cam0", src / "cam1", src / "calib", seq)
    stereo_config(seq)
    t0 = time.time()
    cli("stereo", seq)
    log(f"stereo stage, {len(scenes)} frames incl. compilation: {time.time() - t0:.1f} s")
    wds = frame_workdirs(seq)
    check(len(wds) == len(scenes), f"{len(scenes)} workdirs")
    for i, (wd, sc) in enumerate(zip(wds, scenes)):
        check("windowed" in frame_report(wd)[2], f"frame {i} took the windowed (c2f) path")
        elevation_gate(wd, sc, rig, f"frame {i} (c2f)")

    # The same first frame at full range (c2f off): the fallback route.
    full = work / "seq_full"
    shutil.copytree(wds[0].path, full / wds[0].path.name)
    cfg = _load_pipeline(seq).cfg
    cfg.stereo = dataclasses.replace(cfg.stereo, c2f_window=0)
    SequencePipeline(full, cfg).stereo()
    wd_full = frame_workdirs(full)[0]
    elevation_gate(wd_full, scenes[0], rig, "frame 0 (full range)")
    p_c2f, p_full = wds[0].load_plane(), wd_full.load_plane()
    log(f"frame 0 plane c2f {p_c2f} vs full range {p_full}")
    check(float(np.abs(p_c2f - p_full).max()) < 0.05, "c2f and full-range planes agree")


def phase_calibration(work: Path, rig, scenes) -> None:
    from wass_tpu.cli.pipeline import SequencePipeline
    from wass_tpu.io.workdir import frame_workdirs
    from wass_tpu.testing.gpu_checks import MAX_DR, MAX_DT, MAX_EPI_PX, MIN_MATCHES, pose_errors

    src = work / "frames_nocal"
    write_sequence(src, rig, [(s.img0, s.img1) for s in scenes], with_extrinsics=False)
    seq = work / "seq_cal"
    cli("prepare", src / "cam0", src / "cam1", src / "calib", seq)
    t0 = time.time()
    cli("match", seq)
    log(f"match stage, {len(scenes)} frames incl. compilation: {time.time() - t0:.1f} s")
    for i, wd in enumerate(frame_workdirs(seq)):
        n, epi = (wd.path / "matcher_stats.csv").read_text().splitlines()[1].split(";")[:2]
        log(f"frame {i}: {n} matches, mean epipolar error {float(epi):.4f} px")
        check(int(n) >= MIN_MATCHES and float(epi) <= MAX_EPI_PX,
              f"frame {i}: >= {MIN_MATCHES} matches at <= {MAX_EPI_PX} px")
    res = SequencePipeline(seq).autocalibrate()
    check(res is not None, "autocalibrate found a pose")
    dR, dT = pose_errors(res.R, res.T, rig)
    log(f"autocalibrate: max|dR| {dR:.2e}, max|dT| {dT:.2e}")
    check(dR <= MAX_DR and dT <= MAX_DT, f"pose within |dR| <= {MAX_DR}, |dT| <= {MAX_DT}")


def phase_four(work: Path, W: int = W3, H: int = H3) -> None:
    """The frame-sharded path on four devices against one device."""
    import jax
    import jax.numpy as jnp

    from wass_tpu.calib.ba import lm_refine_two_view
    from wass_tpu.cli.main import _load_pipeline
    from wass_tpu.io.workdir import frame_workdirs
    from wass_tpu.parallel.distba import lm_refine_two_view_sharded
    from wass_tpu.parallel.mesh import make_frame_mesh
    from wass_tpu.testing import add_offband_object

    check(len(jax.devices()) == 4, "four devices")
    rig, scenes = render_frames(8, W, H, seed0=300)
    pairs = [(s.img0.copy(), s.img1.copy()) for s in scenes]
    tripped = 5  # a buoy close to the rig, far outside its rows' disparity band
    k = W / W3
    add_offband_object(*pairs[tripped], y0=int(160 * k), x0=int(1200 * k),
                       size=max(int(160 * k), 80), disparity=max(int(440 * k), 200))
    src = work / "frames4"
    write_sequence(src, rig, pairs, with_extrinsics=True)
    seq = work / "seq4"
    cli("prepare", src / "cam0", src / "cam1", src / "calib", seq)
    stereo_config(seq)
    single = work / "seq1"
    shutil.copytree(seq, single)

    pipe = _load_pipeline(seq)
    t0 = time.time()
    planes4 = pipe.stereo()  # > 1 device: the sharded runner
    log(f"sharded stereo, 8 frames on 4 devices incl. compilation: {time.time() - t0:.1f} s")
    pipe1 = _load_pipeline(single)
    t0 = time.time()
    planes1 = pipe1._stereo_pipelined(frame_workdirs(single))  # DenseStereoPipeline, device 0
    log(f"single-device stereo, 8 frames incl. compilation: {time.time() - t0:.1f} s")
    for i, (wd4, wd1) in enumerate(zip(frame_workdirs(seq), frame_workdirs(single))):
        p4, n4, c4 = frame_report(wd4)
        p1, n1, c1 = frame_report(wd1)
        log(f"frame {i}: 4 devices n={n4} plane={p4} [{c4}]; 1 device n={n1} plane={p1} [{c1}]")
        check(("FALLBACK" in c4) == (i == tripped) and ("FALLBACK" in c1) == (i == tripped),
              f"frame {i}: c2f guard {'trips' if i == tripped else 'holds'} on both paths")
        # Same programs on the same inputs; the sharded step is compiled as
        # one SPMD program, so allow last-bit float differences to move a
        # handful of pixels across a validity threshold.
        check(abs(n4 - n1) <= max(10, n1 * 1e-4), f"frame {i}: n_points agree ({n4} vs {n1})")
        check(float(np.abs(p4 - p1).max()) < 1e-4, f"frame {i}: planes agree")
        check(np.allclose(planes4[i], p4, equal_nan=True), f"frame {i}: returned plane is the written one")
    del planes1

    # Point-sharded Schur-complement BA vs the single-device solve.
    rng = np.random.default_rng(0)
    n = 4096
    R = np.array([[0.968, -0.0196, 0.249], [0.0143, 0.9998, 0.0230], [-0.2494, -0.0187, 0.9680]])
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    T = np.array([-1.0, 0.02, 0.06])
    T /= np.linalg.norm(T)
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(8, 25, n)], 1)
    p0 = X[:, :2] / X[:, 2:] + rng.normal(0, 2e-4, (n, 2))
    x1 = X @ R.T + T
    p1 = x1[:, :2] / x1[:, 2:] + rng.normal(0, 2e-4, (n, 2))
    dR = np.array([[1, -1e-3, 2e-3], [1e-3, 1, -1.5e-3], [-2e-3, 1.5e-3, 1]])
    u, _, vt = np.linalg.svd(dR @ R)
    args = [jnp.asarray(a, jnp.float32) for a in (
        u @ vt, T + np.array([3e-3, -2e-3, 1e-3]), X + rng.normal(0, 0.05, X.shape), p0, p1)]
    mask = jnp.ones(n, bool)
    one = lm_refine_two_view(*args, mask, max_iters=40)
    four = lm_refine_two_view_sharded(make_frame_mesh(4), *args, mask, max_iters=40)
    dRs = float(np.abs(np.asarray(four.R) - np.asarray(one.R)).max())
    dTs = float(np.abs(np.asarray(four.T) - np.asarray(one.T)).max())
    log(f"distributed BA vs single device: max|dR| {dRs:.2e} max|dT| {dTs:.2e}, "
        f"cost {float(one.initial_cost):.3e} -> {float(four.final_cost):.3e}")
    check(dRs < 5e-5 and dTs < 5e-5, "sharded BA == single-device BA")
    Tr = np.asarray(four.T) / np.linalg.norm(np.asarray(four.T))
    check(np.abs(np.asarray(four.R) - R).max() < 1e-3 and np.abs(Tr - T).max() < 5e-3,
          "sharded BA recovers the pose")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the frame-sharded path on four devices")
    args = ap.parse_args()

    print(card_line(), flush=True)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 2

    from wass_tpu.utils.compile_cache import enable_compile_cache

    log(f"JAX {jax.__version__} on {len(devices)} x {devices[0].device_kind}; "
        f"compile cache {enable_compile_cache()}")
    t_all = time.time()
    work = Path(tempfile.mkdtemp(prefix="wass_chip_smoke_"))
    try:
        if args.four:
            phase_four(work)
        else:
            t0 = time.time()
            phase_kernels()
            log(f"phase kernels: {time.time() - t0:.1f} s")
            t0 = time.time()
            phase_precision()
            log(f"phase precision: {time.time() - t0:.1f} s")
            rig, scenes = render_frames(4, W3, H3, seed0=300)
            t0 = time.time()
            phase_stereo(work, rig, scenes)
            log(f"phase stereo: {time.time() - t0:.1f} s")
            t0 = time.time()
            phase_calibration(work, rig, scenes)
            log(f"phase calibration: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"total {time.time() - t_all:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
