"""Checks of the GPU build against the plain references and the reference
quality gates, shared by chip_smoke.py and the `gpu` test tier
(tests/test_gpu_gates.py).

Gates (the verify harness of the reference):
* dense elevation: trimmed-mean plane-aligned error < 0.02 baseline units
  (/root/reference/test/verify_meshes.m:26-30);
* matcher: >= 400 matches at <= 0.5 px mean epipolar error
  (/root/reference/test/verify_matcher.m:5-8,18-25);
* pose: |dR| <= 5e-3, |dT| <= 2e-2 against ground truth (verify_matcher.m:7-8).
"""

from __future__ import annotations

import time

import numpy as np

ELEVATION_GATE = 0.02
MIN_MATCHES = 400
MAX_EPI_PX = 0.5
MAX_DR = 5e-3
MAX_DT = 2e-2
WINDOW = 128  # c2f window at its default


def _timed(fn, *args, reps: int = 3):
    """(result, best wall time in ms over reps runs after one warm-up)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e3


def check_sgm_kernel(H: int, W: int, num_disp: int, directions: int, windowed: bool,
                     seed: int = 0, P1: int = 8, P2: int = 96, print_memory: bool = False):
    """The CUDA aggregation against the plain JAX reference on a random
    (H, W, D) cost volume (D = WINDOW with random per-tile offsets when
    windowed, else num_disp): integer arithmetic, so the int16 sums and the
    WTA disparities must be equal.  Returns a dict with both times (ms)."""
    import jax
    import jax.numpy as jnp

    from wass_tpu.stereo.c2f import TILE_ROWS, wta_disparity_windowed
    from wass_tpu.stereo.sgm import sgm_aggregate, sgm_aggregate_cuda, wta_disparity

    key = jax.random.PRNGKey(seed)
    D = WINDOW if windowed else num_disp
    cost = jax.random.randint(key, (H, W, D), 0, 65, jnp.int32).astype(jnp.uint8)
    offsets = None
    if windowed:
        starts = jax.random.randint(
            jax.random.fold_in(key, 1), (H // TILE_ROWS,), 1, num_disp - WINDOW + 2, jnp.int32
        )
        offsets = jnp.repeat(starts, TILE_ROWS)

    kern = jax.jit(lambda c, o: sgm_aggregate_cuda(c, P1, P2, directions, o))
    ref = jax.jit(lambda c, o: sgm_aggregate(c, P1, P2, directions, o))
    if print_memory:
        print(f"# SGM kernel {H}x{W} D={D} memory_analysis: "
              f"{kern.lower(cost, offsets).compile().memory_analysis()}", flush=True)
    a_k, t_k = _timed(kern, cost, offsets)
    a_r, t_r = _timed(ref, cost, offsets, reps=1)
    sums_equal = bool(jnp.array_equal(a_k, a_r))
    if windowed:
        wta = jax.jit(lambda a, o: wta_disparity_windowed(a, o, 1))
        d_k, d_r = wta(a_k, offsets), wta(a_r, offsets)
    else:
        wta = jax.jit(lambda a: wta_disparity(a, 1, 1))
        d_k, d_r = wta(a_k), wta(a_r)
    wta_equal = bool(jnp.array_equal(d_k, d_r))
    return {
        "H": H, "W": W, "D": D, "directions": directions, "windowed": windowed,
        "sums_equal": sums_equal, "wta_equal": wta_equal,
        "kernel_ms": round(t_k, 3), "reference_ms": round(t_r, 3),
    }


def elevation_error(pts_cam: np.ndarray, plane: np.ndarray, points0: np.ndarray,
                    K0: np.ndarray, baseline: float) -> float:
    """Trimmed-mean (99.9 %) plane-aligned elevation error in baseline units
    of (N, 3) cam0-frame points against the scene's ground-truth point map
    (the bench's verify_meshes-style measure)."""
    H, W = points0.shape[:2]
    pts = np.asarray(pts_cam, np.float64)
    plane = np.asarray(plane, np.float64)
    uv = pts @ np.asarray(K0).T
    uv = uv[:, :2] / uv[:, 2:3]
    xi = np.clip(uv[:, 0].astype(int), 0, W - 1)
    yi = np.clip(uv[:, 1].astype(int), 0, H - 1)
    gt = points0[yi, xi] / baseline
    err = np.abs((pts @ plane[:3]) - (gt @ plane[:3]))
    ae = np.sort(err[np.isfinite(err)])
    return float(ae[: int(len(ae) * 0.999)].mean())


def pose_errors(R: np.ndarray, T: np.ndarray, rig) -> tuple:
    """(max |dR|, max |dT|) of a recovered pose against the rig's, with T
    compared at unit norm."""
    Tg = rig.T / np.linalg.norm(rig.T)
    T = np.asarray(T, np.float64).ravel()
    return (float(np.abs(np.asarray(R) - rig.R).max()),
            float(np.abs(T / np.linalg.norm(T) - Tg).max()))


def precision_checks(seed: int = 0) -> dict:
    """Each float32 product that feeds a gate, run on realistic inputs under
    the default matmul precision and under "highest".  The products are
    pinned to HIGHEST in the code, so on a GPU whose default is TF32 the two
    must still agree exactly; any difference means a pin is missing.
    Returns {stage: max abs difference}."""
    import jax
    import jax.numpy as jnp

    from wass_tpu.match.features import FeatureSet
    from wass_tpu.match.matcher import generate_candidates
    from wass_tpu.stereo.dense import (
        DenseStereoConfig, _stage_export, build_geom_pack, prepare_frame_geometry,
        triangulate_dense,
    )
    from wass_tpu.stereo.plane import plane_distance, refine_plane
    from wass_tpu.testing.synthetic import make_rig

    rng = np.random.default_rng(seed)
    H, W = 384, 512
    # A sea-like point grid: a tilted plane 10-60 baseline units away.
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = 10.0 + 50.0 * (1.0 - yy / H)
    pts = np.stack([(xx - W / 2) / 600.0 * z, (yy - H / 2) / 600.0 * z, z], -1)
    pts += rng.normal(0, 0.01, pts.shape)
    pts = jnp.asarray(pts, jnp.float32)
    valid = jnp.asarray(rng.random((H, W)) > 0.1)
    plane = np.asarray([0.01, -0.9, 0.43, 2.1], np.float32)
    plane[:3] /= np.linalg.norm(plane[:3])
    plane = jnp.asarray(plane)

    rig = make_rig(width=W, height=H)
    geom = prepare_frame_geometry(rig.K0, rig.K1, rig.R, rig.T, (W, H))
    gp = build_geom_pack(geom, (H, W))
    disp = jnp.asarray(20.0 + 30.0 * yy / H + rng.normal(0, 0.3, (H, W)), jnp.float32)
    img = jnp.asarray(rng.uniform(0, 250, (H, W)), jnp.float32)
    cfg = DenseStereoConfig(num_disp=64)

    desc = rng.normal(size=(2, 2048, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)

    def features(d):
        K = d.shape[0]
        z1 = jnp.zeros((K,), jnp.float32)
        return FeatureSet(jnp.zeros((K, 2)), z1, z1, z1, d, jnp.ones((K,), bool))

    def candidates(a, b):
        c = generate_candidates(features(a), features(b))
        return jnp.stack([c.src, c.dst, c.valid.astype(jnp.int32)])

    def triangulate(d):
        p, v, reasons = triangulate_dense(d, gp, img, img, cfg)
        return jnp.concatenate([p.reshape(-1), reasons.reshape(-1).astype(jnp.float32)])

    stages = {
        "plane_distance": (lambda p, x: plane_distance(p, x), (plane, pts)),
        "refine_plane": (lambda x, v: refine_plane(x, v), (pts, valid)),
        "triangulate_angle_gate": (triangulate, (disp,)),
        "export_transform": (lambda x, v, p: _stage_export(x, v, p)[0], (pts, valid, plane)),
        "matcher_candidates": (candidates, (jnp.asarray(desc[0]), jnp.asarray(desc[1]))),
    }
    out = {}
    for name, (fn, args) in stages.items():
        a = np.asarray(jax.jit(fn)(*args), np.float64)
        with jax.default_matmul_precision("highest"):
            b = np.asarray(jax.jit(fn)(*args), np.float64)
        out[name] = float(np.max(np.abs(a - b)))
    return out
