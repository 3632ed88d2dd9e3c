"""Robustness study: matcher + dense stereo under degraded imagery.

The reference ships a JPEG-compression robustness experiment for the
dense stage (/root/reference/test/jpeg_compression_test.m:31-40, quality
sweep 100..70) and chose KAZE features for low-texture water
(/root/reference/src/wass_match/FeatureSet.cpp:199).  This script runs
the equivalent sweep on a synthetic ground-truth scene for BOTH stages:

  matcher: n_matches (gate >= 400 at full res, verify_matcher.m:5,18),
           avg epipolar error (<= 0.5 px), pose recovery vs GT;
  dense:   trimmed-mean plane-aligned elevation error (gate < 0.02
           baseline units, verify_meshes.m:26-30).

Degradations: JPEG quality sweep, additive Gaussian sensor noise,
specular saturation blobs (burned highlights).  Prints a markdown table
for docs/quality.md.

Run on a GPU: python bench/robustness.py
Matcher-only: WASS_ROBUST_MATCH_ONLY=1 python bench/robustness.py
Pooled pose:  WASS_ROBUST_POOLED=1 python bench/robustness.py
              (the PRODUCTION pose path: match 8 degraded frames ->
               autocalibrate pooled reduction -> dR/dT, the estimator the
               per-frame columns only initialize)
Full-res matcher: WASS_ROBUST_FULLRES=1 python bench/robustness.py
              (2048x1536 — the scale where the >=400-match gate is
               defined, verify_matcher.m:5,18)
Dense knobs:  WASS_ROBUST_DENSE_SWEEP=1 python bench/robustness.py
              (census window / P2 / input pre-smoothing under jpeg q95
               and sensor noise — the reference's own mitigation space,
               test/jpeg_compression_test.m:31-40)
"""
import io
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    import imageio.v3 as iio

    buf = io.BytesIO()
    iio.imwrite(buf, np.clip(img, 0, 255).astype(np.uint8), extension=".jpg",
                quality=quality)
    return iio.imread(buf.getvalue()).astype(np.float64)


def add_noise(img: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(img + rng.standard_normal(img.shape) * sigma, 0, 255)


def add_specular(img: np.ndarray, n_blobs: int, seed: int) -> np.ndarray:
    """Saturated sun-glint blobs: gaussian bumps pushed to 255."""
    rng = np.random.default_rng(seed)
    H, W = img.shape
    out = img.copy()
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0.2 * H, 0.9 * H), rng.uniform(0.1 * W, 0.9 * W)
        r = rng.uniform(3, 12)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        out[mask] = 255.0
    return out


# Each degradation takes (img0, img1, k) with k the FRAME index: sensor
# noise is temporally iid on a real camera, so multi-frame sweeps must
# draw a fresh realization per frame (a single shared realization biases
# the pooled estimator in a way no physical sensor does — measured: the
# same sigma=8 half-res config scores pooled dT 1.7e-2 with per-frame
# noise vs 2.1e-2 with one shared realization).  Deterministic
# degradations (JPEG, specular layout) ignore k.
DEGRADATIONS = [
    ("clean", lambda i0, i1, k=0: (i0, i1)),
    ("jpeg q95", lambda i0, i1, k=0: (jpeg_roundtrip(i0, 95), jpeg_roundtrip(i1, 95))),
    ("jpeg q90", lambda i0, i1, k=0: (jpeg_roundtrip(i0, 90), jpeg_roundtrip(i1, 90))),
    ("jpeg q80", lambda i0, i1, k=0: (jpeg_roundtrip(i0, 80), jpeg_roundtrip(i1, 80))),
    ("jpeg q70", lambda i0, i1, k=0: (jpeg_roundtrip(i0, 70), jpeg_roundtrip(i1, 70))),
    ("noise s=3", lambda i0, i1, k=0: (add_noise(i0, 3, 1 + 2 * k), add_noise(i1, 3, 2 + 2 * k))),
    ("noise s=8", lambda i0, i1, k=0: (add_noise(i0, 8, 1 + 2 * k), add_noise(i1, 8, 2 + 2 * k))),
    ("specular x20", lambda i0, i1, k=0: (add_specular(i0, 20, 3), add_specular(i1, 20, 4))),
]


def _canonical_rig_scene(W, H, seed=17, time_s=0.0):
    """Disk-cached canonical-rig scene at (W, H)."""
    from wass_tpu.testing import make_rig, make_scene
    from wass_tpu.testing.synthetic import SyntheticRig

    cache = f"/tmp/wass_robust_scene_{W}x{H}_{seed}_{time_s:g}.npz"
    if os.path.exists(cache):
        z = np.load(cache)
        rig = SyntheticRig(width=W, height=H, **{k: z[k] for k in ("K0", "K1", "R0", "T0", "R1", "T1")})
        return z["img0"], z["img1"], z["points0"], rig
    rig = make_rig(width=W, height=H)
    sc = make_scene(seed=seed, width=W, height=H, wave_amplitude=0.25, rig=rig, time=time_s)
    np.savez_compressed(cache, img0=sc.img0, img1=sc.img1, points0=sc.points0,
                        K0=rig.K0, K1=rig.K1, R0=rig.R0, T0=rig.T0,
                        R1=rig.R1, T1=rig.T1)
    return sc.img0, sc.img1, sc.points0, rig


def pooled_pose_sweep():
    """The production pose path under degradation: match N frames, pool
    the epipolar inliers, run the autocalibrate reduction, report pooled
    dR/dT vs ground truth next to the single-pair initialization."""
    import jax

    from wass_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from wass_tpu.calib.autocalibrate import AutocalConfig, autocalibrate_pooled
    from wass_tpu.match.pipeline import MatchConfig, match_frame

    W, H = 1024, 768
    n_frames = int(os.environ.get("WASS_ROBUST_POOLED_FRAMES", "8"))
    frames = []
    rig = None
    for i in range(n_frames):
        img0, img1, _, rig = _canonical_rig_scene(W, H, seed=17, time_s=i * 0.2)
        frames.append((img0.astype(np.float64), img1.astype(np.float64)))
    mcfg = MatchConfig()
    Tg = rig.T / np.linalg.norm(rig.T)

    rows = []
    for name, fn in DEGRADATIONS:
        t0 = time.time()
        uv0_all, uv1_all, per_frame = [], [], []
        for i, (f0, f1) in enumerate(frames):
            d0, d1 = fn(f0, f1, i)
            res = match_frame(d0, d1, rig.K0, rig.K1, mcfg)
            if res is None:
                continue
            uv0_all.append(res.uv0_epi)
            uv1_all.append(res.uv1_epi)
            per_frame.append(
                (res.n_matches, float(np.abs(res.R - rig.R).max()),
                 float(np.abs(res.T.ravel() - Tg).max()))
            )
        if not uv0_all:
            rows.append((name, 0, 0, float("nan"), float("nan"), float("nan"), float("nan")))
            print(f"# {name}: ALL FRAMES FAILED", file=sys.stderr)
            continue
        ac = autocalibrate_pooled(
            np.concatenate(uv0_all), np.concatenate(uv1_all),
            rig.K0, rig.K1, AutocalConfig(),
        )
        if ac is None:
            rows.append((name, len(per_frame), 0, float("nan"), float("nan"), float("nan"), float("nan")))
            print(f"# {name}: AUTOCAL FAILED", file=sys.stderr)
            continue
        dR = float(np.abs(ac.R - rig.R).max())
        dT = float(np.abs(ac.T.ravel() - Tg).max())
        med_pf_dR = float(np.median([p[1] for p in per_frame]))
        med_pf_dT = float(np.median([p[2] for p in per_frame]))
        rows.append((name, len(per_frame), ac.n_inliers, med_pf_dR, med_pf_dT, dR, dT))
        print(f"# {name}: {len(per_frame)}/{n_frames} frames, {ac.n_inliers} pooled inliers, "
              f"per-frame med dR/dT {med_pf_dR:.2e}/{med_pf_dT:.2e} -> "
              f"POOLED dR {dR:.2e} dT {dT:.2e} ({time.time()-t0:.1f}s)", file=sys.stderr)

    print("\n| Degradation | frames ok | pooled inliers | per-frame med dR | per-frame med dT | POOLED dR (<=5e-3) | POOLED dT (<=2e-2) |")
    print("|---|---|---|---|---|---|---|")
    for name, nf, ni, pdR, pdT, dR, dT in rows:
        print(f"| {name} | {nf} | {ni} | {pdR:.1e} | {pdT:.1e} | {dR:.1e} | {dT:.1e} |")


def noise_s8_sweep():
    """Mitigation search for the one degradation with no passing row in
    r04: additive sensor noise sigma=8.  Sweeps the matcher pre-smoothing
    sigma (the auto policy's noise_heavy tier) and a doubled feature
    budget over the pooled production pose path."""
    import dataclasses

    import jax

    from wass_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from wass_tpu.calib.autocalibrate import AutocalConfig, autocalibrate_pooled
    from wass_tpu.match.pipeline import MatchConfig, match_frame

    W, H = 1024, 768
    n_frames = 8
    frames = []
    rig = None
    for i in range(n_frames):
        img0, img1, _, rig = _canonical_rig_scene(W, H, seed=17, time_s=i * 0.2)
        frames.append((img0.astype(np.float64), img1.astype(np.float64)))
    Tg = rig.T / np.linalg.norm(rig.T)

    variants = [
        ("sigma=0.8", MatchConfig(input_smooth_sigma=0.8)),
        ("sigma=1.2", MatchConfig(input_smooth_sigma=1.2)),
        ("sigma=1.5", MatchConfig(input_smooth_sigma=1.5)),
        ("sigma=2.0", MatchConfig(input_smooth_sigma=2.0)),
        ("sigma=2.5", MatchConfig(input_smooth_sigma=2.5)),
        ("sigma=3.0", MatchConfig(input_smooth_sigma=3.0)),
        ("sigma=2.0 nf=4000",
         MatchConfig(input_smooth_sigma=2.0, num_features=4000)),
        ("sigma=2.0 16f", MatchConfig(input_smooth_sigma=2.0)),
    ]
    print("\n| noise s=8 variant | frames ok | pooled inliers | POOLED dR (<=5e-3) | POOLED dT (<=2e-2) |")
    print("|---|---|---|---|---|")
    for name, mcfg in variants:
        n_use = 16 if "16f" in name else n_frames
        uv0_all, uv1_all, nf_ok = [], [], 0
        for i in range(n_use):
            f0, f1 = frames[i % n_frames]
            # Fresh iid noise per frame (what a real sensor produces).
            d0 = add_noise(f0, 8, 1 + 2 * i)
            d1 = add_noise(f1, 8, 2 + 2 * i)
            res = match_frame(d0, d1, rig.K0, rig.K1, mcfg)
            if res is None:
                continue
            nf_ok += 1
            uv0_all.append(res.uv0_epi)
            uv1_all.append(res.uv1_epi)
        if not uv0_all:
            print(f"| {name} | 0 | - | - | - |")
            continue
        ac = autocalibrate_pooled(
            np.concatenate(uv0_all), np.concatenate(uv1_all),
            rig.K0, rig.K1, AutocalConfig(),
        )
        if ac is None:
            print(f"| {name} | {nf_ok} | 0 | - | - |")
            continue
        dR = float(np.abs(ac.R - rig.R).max())
        dT = float(np.abs(ac.T.ravel() - Tg).max())
        print(f"| {name} | {nf_ok} | {ac.n_inliers} | {dR:.1e} | {dT:.1e} |")
        sys.stdout.flush()


def fullres_matcher_sweep():
    """Matcher degradation rows at 2048x1536 — the resolution class where
    the >=400-match gate is defined (verify_matcher.m:5,18)."""
    import jax

    from wass_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from wass_tpu.match.pipeline import MatchConfig, match_frame

    W, H = 2048, 1536
    img0, img1, _, rig = _canonical_rig_scene(W, H, seed=17)
    mcfg = MatchConfig()
    Tg = rig.T / np.linalg.norm(rig.T)
    rows = []
    for name, fn in DEGRADATIONS:
        d0, d1 = fn(img0.astype(np.float64), img1.astype(np.float64))
        t0 = time.time()
        res = match_frame(d0, d1, rig.K0, rig.K1, mcfg)
        if res is None:
            rows.append((name, 0, float("nan"), float("nan"), float("nan")))
            print(f"# {name}: MATCH FAILED", file=sys.stderr)
            continue
        dR = float(np.abs(res.R - rig.R).max())
        dT = float(np.abs(res.T.ravel() - Tg).max())
        rows.append((name, res.n_matches, res.epi_avg, dR, dT))
        print(f"# {name}: {res.n_matches} matches, epi {res.epi_avg:.3f}, "
              f"dR {dR:.2e} dT {dT:.2e} ({time.time()-t0:.1f}s)", file=sys.stderr)
    print("\n| Degradation (2048x1536) | matches (gate >=400) | epi err px (<=0.5) | dR | dT |")
    print("|---|---|---|---|---|")
    for name, n, epi, dR, dT in rows:
        print(f"| {name} | {n} | {epi:.3f} | {dR:.1e} | {dT:.1e} |")


def dense_knob_sweep():
    """Dense-stage mitigation sweep under the gate-blowing degradations:
    census window x P2 x input pre-smoothing (host gaussian), measured as
    trimmed-mean elevation error with GT extrinsics."""
    import dataclasses

    import jax
    from scipy.ndimage import gaussian_filter

    from wass_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from wass_tpu.stereo.dense import DenseStereoConfig, dense_stereo_frame

    W, H = 1024, 768
    img0, img1, points0, rig = _canonical_rig_scene(W, H, seed=17)
    base = DenseStereoConfig(num_disp=192, min_disp=1,
                             plane_ransac_threshold=0.1, plane_max_distance=0.3)

    degr = dict(DEGRADATIONS)
    cases = [("clean", degr["clean"]), ("jpeg q95", degr["jpeg q95"]),
             ("noise s=3", degr["noise s=3"])]
    knobs = []
    for cw in [(7, 9), (9, 11)]:
        for p2 in [96, 192]:
            for sigma in [0.0, 0.8, 1.5]:
                knobs.append((cw, p2, sigma))

    def run(cfg, d0, d1):
        out, _ = dense_stereo_frame(
            d0.astype(np.float32), d1.astype(np.float32),
            rig.K0, rig.K1, rig.R, rig.T, cfg,
        )
        valid = np.asarray(out.valid)
        pts = np.asarray(out.points)[valid]
        plane = np.asarray(out.plane, np.float64)
        if not (np.all(np.isfinite(plane)) and len(pts)):
            return float("nan")
        uv = pts @ np.asarray(rig.K0).T
        uv = uv[:, :2] / uv[:, 2:3]
        xi = np.clip(uv[:, 0].astype(int), 0, W - 1)
        yi = np.clip(uv[:, 1].astype(int), 0, H - 1)
        gt = points0[yi, xi] / rig.baseline
        err = np.abs((pts @ plane[:3]) - (gt @ plane[:3]))
        ae = np.sort(err[np.isfinite(err)])
        return float(ae[: int(len(ae) * 0.999)].mean())

    print("\n| census win | P2 | pre-smooth sigma | " + " | ".join(n for n, _ in cases) + " |")
    print("|---|---|---|" + "---|" * len(cases))
    for cw, p2, sigma in knobs:
        cfg = dataclasses.replace(base, census_win=cw, p2=p2)
        errs = []
        for name, fn in cases:
            d0, d1 = fn(img0.astype(np.float64), img1.astype(np.float64))
            if sigma > 0:
                d0 = gaussian_filter(d0, sigma)
                d1 = gaussian_filter(d1, sigma)
            try:
                errs.append(run(cfg, d0, d1))
            except Exception as e:
                print(f"# {cw} P2={p2} s={sigma} {name}: {e}", file=sys.stderr)
                errs.append(float("nan"))
        print(f"| {cw} | {p2} | {sigma} | " + " | ".join(f"{e:.4f}" for e in errs) + " |")
        sys.stdout.flush()


def main():
    import jax

    from wass_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from wass_tpu.match.pipeline import MatchConfig, match_frame
    from wass_tpu.stereo.dense import DenseStereoConfig, dense_stereo_frame
    from wass_tpu.testing import make_scene

    W, H = 1024, 768
    match_only = os.environ.get("WASS_ROBUST_MATCH_ONLY", "0") == "1"

    cache = f"/tmp/wass_robust_scene_{W}x{H}_rig.npz"
    if os.path.exists(cache):
        z = np.load(cache)
        from wass_tpu.testing.synthetic import SyntheticRig

        rig = SyntheticRig(width=W, height=H, **{k: z[k] for k in ("K0", "K1", "R0", "T0", "R1", "T1")})
        img0, img1, points0 = z["img0"], z["img1"], z["points0"]
    else:
        # Canonical rig (same construction as bench.py/bench_accuracy and
        # the quality.md matcher-gate row): pose recoverability depends on
        # the rig geometry, so a random per-seed rig would confound the
        # degradation sweep with rig hardness.
        from wass_tpu.testing import make_rig

        rig = make_rig(width=W, height=H)
        sc = make_scene(seed=17, width=W, height=H, wave_amplitude=0.25, rig=rig)
        rig = sc.rig
        img0, img1, points0 = sc.img0, sc.img1, sc.points0
        np.savez_compressed(cache, img0=img0, img1=img1, points0=points0,
                            K0=rig.K0, K1=rig.K1, R0=rig.R0, T0=rig.T0,
                            R1=rig.R1, T1=rig.T1)

    # Production defaults: the detector's robustness is reported for the
    # configuration users run.
    mcfg = MatchConfig()
    scfg = DenseStereoConfig(num_disp=192, min_disp=1,
                             plane_ransac_threshold=0.1, plane_max_distance=0.3)
    Tg = rig.T / np.linalg.norm(rig.T)

    rows = []
    for name, fn in DEGRADATIONS:
        d0, d1 = fn(img0.astype(np.float64), img1.astype(np.float64))
        t0 = time.time()
        res = match_frame(d0, d1, rig.K0, rig.K1, mcfg)
        if res is None:
            rows.append((name, 0, float("nan"), float("nan"), float("nan"), float("nan")))
            print(f"# {name}: MATCH FAILED", file=sys.stderr)
            continue
        dR = float(np.abs(res.R - rig.R).max())
        dT = float(np.abs(res.T.ravel() - Tg).max())
        derr = float("nan")
        if not match_only:
            out, _geom = dense_stereo_frame(
                d0.astype(np.float32), d1.astype(np.float32),
                rig.K0, rig.K1, rig.R, rig.T, scfg,
            )
            valid = np.asarray(out.valid)
            pts = np.asarray(out.points)[valid]
            plane = np.asarray(out.plane, np.float64)
            if np.all(np.isfinite(plane)) and len(pts):
                uv = pts @ np.asarray(rig.K0).T
                uv = uv[:, :2] / uv[:, 2:3]
                xi = np.clip(uv[:, 0].astype(int), 0, W - 1)
                yi = np.clip(uv[:, 1].astype(int), 0, H - 1)
                gt = points0[yi, xi] / rig.baseline
                err = np.abs((pts @ plane[:3]) - (gt @ plane[:3]))
                ae = np.sort(err[np.isfinite(err)])
                derr = float(ae[: int(len(ae) * 0.999)].mean())
        rows.append((name, res.n_matches, res.epi_avg, dR, dT, derr))
        print(f"# {name}: {res.n_matches} matches, epi {res.epi_avg:.3f} px, "
              f"dR {dR:.2e}, dT {dT:.2e}, dense err {derr:.4f} "
              f"({time.time()-t0:.1f}s)", file=sys.stderr)

    print("\n| Degradation | matches (gate >=400) | epi err px (<=0.5) | max|dR| (<=5e-3) | max|dT| (<=2e-2) | dense elev err (<0.02) |")
    print("|---|---|---|---|---|---|")
    for name, n, epi, dR, dT, derr in rows:
        print(f"| {name} | {n} | {epi:.3f} | {dR:.1e} | {dT:.1e} | {derr:.4f} |")


if __name__ == "__main__":
    if os.environ.get("WASS_ROBUST_POOLED", "0") == "1":
        pooled_pose_sweep()
    elif os.environ.get("WASS_ROBUST_S8", "0") == "1":
        noise_s8_sweep()
    elif os.environ.get("WASS_ROBUST_FULLRES", "0") == "1":
        fullres_matcher_sweep()
    elif os.environ.get("WASS_ROBUST_DENSE_SWEEP", "0") == "1":
        dense_knob_sweep()
    else:
        main()
