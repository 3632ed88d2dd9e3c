"""The image-preparation stage (wass_prepare equivalent).

Per frame: load raw images + per-camera intrinsics/distortion, optional
polarimetric demosaic path, optional CLAHE, undistort, and populate the
workdir contract (undistorted/0000000{0,1}.png, per-frame intrinsics XMLs,
extrinsics passthrough) — mirroring main() of
/root/reference/src/wass_prepare/wass_prepare.cpp:303-540.

The compute path (CLAHE + undistort, or the polarimetric chain) is one
jitted device program; file IO stays on the host.
"""

from __future__ import annotations

import dataclasses
import shutil
from functools import partial
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from wass_tpu.io.workdir import Workdir
from wass_tpu.io import matrices
from wass_tpu.ops.sampling import undistort_image
from wass_tpu.prepare.clahe import clahe
from wass_tpu.prepare.polar import polarimetric_process


@dataclasses.dataclass(frozen=True)
class PrepareConfig:
    """Defaults mirror wass_prepare's incfg options (:36-39) and CLI flags."""

    clahe_clip_limit_cam0: float = 2.0
    clahe_tile_px_cam0: int = 0  # 0 disables (CAM0_CLAHE_TILEGRIDSIZE)
    clahe_clip_limit_cam1: float = 2.0
    clahe_tile_px_cam1: int = 0
    demosaic: bool = False
    hdr: bool = False
    save_stokes: bool = False  # write _S0/_S1/_S2.tiff next to the PNGs


@partial(jax.jit, static_argnames=("clahe_tiles", "clip_limit"))
def _prepare_device(img, K, dist, clahe_tiles: Tuple[int, int], clip_limit: float):
    if clahe_tiles != (0, 0):
        img = clahe(img, clip_limit, tiles_x=clahe_tiles[1], tiles_y=clahe_tiles[0])
    return undistort_image(img, K, dist)


def prepare_image(
    img: np.ndarray,
    K: np.ndarray,
    dist: np.ndarray,
    cfg: PrepareConfig,
    cam: int,
    out_stokes_prefix=None,
) -> np.ndarray:
    """Process one raw frame into its undistorted 8-bit image."""
    imgj = jnp.asarray(img, jnp.float32)
    Kj = jnp.asarray(K, jnp.float32)
    dj = jnp.asarray(np.asarray(dist).reshape(-1), jnp.float32)

    if cfg.demosaic:
        res = polarimetric_process(imgj, Kj, dj, use_hdr=cfg.hdr)
        out = res.intensity
        if cfg.save_stokes and out_stokes_prefix is not None:
            import imageio.v3 as iio

            for name, arr in (("S0", res.S0), ("S1", res.S1), ("S2", res.S2)):
                iio.imwrite(f"{out_stokes_prefix}_{name}.tiff", np.asarray(arr, np.float32))
        tile_px = cfg.clahe_tile_px_cam0 if cam == 0 else cfg.clahe_tile_px_cam1
        clip = cfg.clahe_clip_limit_cam0 if cam == 0 else cfg.clahe_clip_limit_cam1
        if tile_px > 0:
            H, W = out.shape
            out = clahe(out, clip, tiles_x=max(W // tile_px, 1), tiles_y=max(H // tile_px, 1))
        return np.clip(np.asarray(out), 0, 255)

    tile_px = cfg.clahe_tile_px_cam0 if cam == 0 else cfg.clahe_tile_px_cam1
    clip = cfg.clahe_clip_limit_cam0 if cam == 0 else cfg.clahe_clip_limit_cam1
    H, W = img.shape
    tiles = (max(H // tile_px, 1), max(W // tile_px, 1)) if tile_px > 0 else (0, 0)
    if tiles == (0, 0) and not np.any(np.asarray(dist)):
        # Zero distortion and no CLAHE: cv::undistort degenerates to the
        # identity (wass_prepare.cpp:268) — skip the device remap.
        return np.clip(np.asarray(img, np.float64), 0, 255)
    out = _prepare_device(imgj, Kj, dj, tiles, clip)
    return np.clip(np.asarray(out), 0, 255)


def prepare_frame(
    workdir_path,
    img0: np.ndarray,
    img1: np.ndarray,
    K0: np.ndarray,
    d0: np.ndarray,
    K1: np.ndarray,
    d1: np.ndarray,
    cfg: PrepareConfig = PrepareConfig(),
    ext_R: Optional[np.ndarray] = None,
    ext_T: Optional[np.ndarray] = None,
) -> Workdir:
    """Create and populate one frame workdir (the wass_prepare contract)."""
    wd = Workdir(workdir_path).create()
    pref0 = wd.path / "undistorted" / "00000000" if cfg.save_stokes else None
    pref1 = wd.path / "undistorted" / "00000001" if cfg.save_stokes else None
    u0 = prepare_image(img0, K0, d0, cfg, cam=0, out_stokes_prefix=pref0)
    u1 = prepare_image(img1, K1, d1, cfg, cam=1, out_stokes_prefix=pref1)
    wd.save_undistorted(0, u0)
    wd.save_undistorted(1, u1)
    wd.save_intrinsics(0, K0)
    wd.save_intrinsics(1, K1)
    # Extrinsics passthrough (wass_prepare.cpp:504-523): known calibration
    # lets the pipeline skip match/autocalibrate.
    if ext_R is not None and ext_T is not None:
        wd.save_extrinsics(ext_R, ext_T)
    return wd
