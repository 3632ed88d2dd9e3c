"""Probe: matcher output vs the detector's determinant-of-Hessian threshold.

Two questions, one process:

1. Why the float32 detector finds fewer matches than the counts recorded
   for this matcher on a device whose unpinned f32 products ran as one
   bf16 pass.  Seed 17 (the scene of bench/_probe_fullres_margin.py) is
   matched with exact f32 products and again with every unpinned f32 dot
   and convolution taking bf16-rounded operands (f32 accumulation).
   Products run under jax.default_matmul_precision("highest") (pose
   RANSAC, BA) stay exact in both; per-call pins (the matcher's distance
   matrix) are rounded too, as that build had none.
2. Which single threshold to use at every frame size: held-out seeds
   (never used to pick the value) at 1, 3 and 5 MP, 8-bit inputs as the
   pipeline reads them, against the reference gates (>= 400 matches at
   <= 0.5 px at full resolution; single-pair pose |dR| <= 5e-3,
   |dT| <= 2e-2).

Run: python bench/_probe_hessian_threshold.py [--out FILE] [--sizes 1024x768,...]
"""

import argparse
import contextlib
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax._src import config as _jax_config
from jax._src.lax import convolution as _lax_conv
from jax._src.lax import lax as _lax

from wass_tpu.match.pipeline import MatchConfig, match_frame
from wass_tpu.testing import make_rig, make_scene
from wass_tpu.testing.gpu_checks import pose_errors

_dot, _conv = _lax.dot_general, _lax_conv.conv_general_dilated


def _unpinned() -> bool:
    return _jax_config.default_matmul_precision.value in (None, "default", "bfloat16")


def _bf16(a):
    """Round f32 to the nearest bf16 (ties to even), kept in f32.  Done on
    the bits: XLA may drop an f32 -> bf16 -> f32 convert pair."""
    a = jnp.asarray(a)
    if a.dtype != jnp.float32:
        return a
    u = jax.lax.bitcast_convert_type(a, jnp.uint32)
    u = (u + jnp.uint32(0x7FFF) + ((u >> 16) & 1)) & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


def _dot_bf16(lhs, rhs, dimension_numbers, precision=None, **kw):
    if _unpinned():
        lhs, rhs, precision = _bf16(lhs), _bf16(rhs), jax.lax.Precision.HIGHEST
    return _dot(lhs, rhs, dimension_numbers, precision=precision, **kw)


def _conv_bf16(lhs, rhs, *args, precision=None, **kw):
    if _unpinned():
        lhs, rhs, precision = _bf16(lhs), _bf16(rhs), jax.lax.Precision.HIGHEST
    return _conv(lhs, rhs, *args, precision=precision, **kw)


@contextlib.contextmanager
def bf16_products():
    """Every unpinned f32 dot / convolution with bf16-rounded operands."""
    _lax.dot_general, _lax_conv.conv_general_dilated = _dot_bf16, _conv_bf16
    jax.clear_caches()
    try:
        yield
    finally:
        _lax.dot_general, _lax_conv.conv_general_dilated = _dot, _conv
        jax.clear_caches()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--sizes", default="1024x768,2048x1536,2560x1920")
    ap.add_argument("--seeds", default="200,201,202,203")
    ap.add_argument("--thresholds", default="1e-4,3e-5,1e-5")
    ap.add_argument("--origin-size", default="2048x1536")
    args = ap.parse_args()
    out = open(args.out, "w") if args.out else None

    def emit(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                        capture_output=True, text=True).stdout.strip() or "# no nvidia-smi")
    emit(f"# JAX {jax.__version__} on {jax.devices()[0].device_kind}")

    def run(tag, img0, img1, rig, thr):
        t0 = time.time()
        res = match_frame(img0, img1, rig.K0, rig.K1, MatchConfig(hessian_threshold=thr))
        dt = time.time() - t0
        if res is None:
            emit(f"{tag} thr={thr:g}: FAILED {dt:.1f}s")
            return
        dR, dT = pose_errors(res.R, res.T, rig)
        emit(f"{tag} thr={thr:g}: n={res.n_matches} epi={res.epi_avg:.3f}px "
             f"dR={dR:.2e} dT={dT:.2e} {dt:.1f}s")

    # 1. The cause: seed 17, float input (as the earlier record), exact f32
    #    products vs bf16-rounded operands.
    W, H = (int(v) for v in args.origin_size.split("x"))
    rig = make_rig(width=W, height=H)
    sc = make_scene(seed=17, wave_amplitude=0.25, rig=rig, on_device=True)
    f0, f1 = sc.img0.astype(np.float64), sc.img1.astype(np.float64)
    run(f"{W}x{H} seed 17 float as-built", f0, f1, rig, 1e-4)
    with bf16_products():
        x = jnp.ones((4, 4), jnp.float32) * (1 + 2**-12)
        assert float((x @ x)[0, 0]) == 4.0, "bf16 emulation inactive"
        run(f"{W}x{H} seed 17 float bf16-operands", f0, f1, rig, 1e-4)

    # 2. Held-out seeds, 8-bit inputs (the PNG writer truncates to uint8).
    thrs = [float(t) for t in args.thresholds.split(",")]
    for size in filter(None, args.sizes.split(",")):
        W, H = (int(v) for v in size.split("x"))
        rig = make_rig(width=W, height=H)
        for seed in (int(s) for s in args.seeds.split(",")):
            sc = make_scene(seed=seed, wave_amplitude=0.25, rig=rig, on_device=True)
            q0, q1 = (np.clip(a, 0, 255).astype(np.uint8).astype(np.float64)
                      for a in (sc.img0, sc.img1))
            for thr in thrs:
                run(f"{W}x{H} seed {seed} 8-bit", q0, q1, rig, thr)
    if out:
        out.close()


if __name__ == "__main__":
    main()
