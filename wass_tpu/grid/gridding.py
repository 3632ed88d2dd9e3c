"""Per-frame point-cloud -> regular-grid surface reconstruction.

wassgridsurface --action grid equivalent (_grid_task,
/root/reference/gridding/wassgridsurface/wassgridsurface.py:304-523):
align the compressed camera mesh to the sea plane, quantize points into
grid cells with NREPS=10 random-subsample *median stacking*, interpolate
the holes (DCT / IDW), optional median filter, and stream frames into the
NetCDF cube.

Device shape of the median stacking: the reference scatters a random
permutation per repetition (last-write-wins) into a (H, W, NREPS) buffer
and takes nanmedian.  Here each repetition is a jnp scatter with a random
permutation — identical semantics, batched on device.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from wass_tpu.grid.setup import GridSetup, align_on_sea_plane
from wass_tpu.grid.interpolators import dct_interpolate, idw_interpolate
from wass_tpu.io.workdir import Workdir
from wass_tpu.io.xyzc import load_camera_mesh
from wass_tpu.ops.morphology import median_filter


@dataclasses.dataclass(frozen=True)
class GridConfig:
    algorithm: str = "DCT"  # DCT | IDW | LinearND (wassgridsurface.py:639)
    nreps: int = 10
    subsample_percent: float = 100.0
    median_filter_size: int = 0
    dct_nfreqs: int = 150
    dct_iters: int = 500
    dct_alpha: float = 8e-7
    seed: int = 0
    # Local-plane outlier voting before gridding (filter_mesh_outliers,
    # wass_utils.py:72-163; its call-site is commented out in the
    # reference, wassgridsurface.py:453-454 — off by default here too).
    filter_outliers: bool = False
    outlier_threshold: float = 0.2
    # Chunked per-point zero-mean rewrite after gridding
    # (wassgridsurface.py:543-576).
    force_zero_mean: bool = False
    # Which camera's undistorted frame is JPEG-pushed into the cube
    # (wassgridsurface.py:494, image_id_to_save).
    image_id_to_save: int = 0
    save_images: bool = True
    # Differentiable photo-consistency refinement of the gridded surface
    # (grid/variational.py — the reference's experimental
    # TFVariationalRefinement, call-site commented out there; off by
    # default here too).
    variational: bool = False
    variational_iters: int = 400
    variational_alpha: float = 10.0


@partial(jax.jit, static_argnames=("shape", "nreps", "n_use"))
def _median_stack(pts_x, pts_y, pts_z, good, key, shape, nreps: int, n_use: int):
    """(H, W) nanmedian of nreps last-write-wins scatters of a random
    subsample (wassgridsurface.py:330-346)."""
    H, W = shape
    npts = pts_x.shape[0]
    flat = pts_y * W + pts_x
    flat = jnp.where(good, flat, H * W)  # dump invalid into a bin off-grid

    def one_rep(k):
        perm = jax.random.permutation(k, npts)
        sel = perm[:n_use]
        buf = jnp.full((H * W + 1,), jnp.nan, jnp.float32)
        buf = buf.at[flat[sel]].set(pts_z[sel], mode="drop")
        return buf[: H * W].reshape(H, W)

    keys = jax.random.split(key, nreps)
    ZZ = jax.vmap(one_rep)(keys)
    return jnp.nanmedian(ZZ, axis=0)


def grid_frame(
    workdir: Workdir,
    setup: GridSetup,
    cfg: GridConfig = GridConfig(),
    user_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grid one frame: returns (Z, mask) in meters on the setup's XY grid.

    user_mask: optional (H, W) {0,1} grid mask multiplied into the
    interpolation mask (reference --mask flag, wassgridsurface.py:281-286,
    355-363)."""
    mesh = load_camera_mesh(workdir.path / "mesh_cam.xyzC")
    meanplane_RT = (setup.Rpl, setup.Tpl)
    mesh_aligned = (setup.Rpl @ mesh + setup.Tpl)
    mesh_aligned[2, :] *= -1.0
    mesh_aligned = mesh_aligned * setup.baseline

    if cfg.filter_outliers and mesh_aligned.shape[1]:
        from wass_tpu.grid.outliers import filter_mesh_outliers

        mesh_aligned = filter_mesh_outliers(mesh_aligned, cfg.outlier_threshold)

    H, W = setup.XX.shape
    sx = setup.xmax - setup.xmin
    sy = setup.ymax - setup.ymin
    px = np.floor((mesh_aligned[0] - setup.xmin) / sx * (W - 1) + 0.5).astype(np.int64)
    py = np.floor((mesh_aligned[1] - setup.ymin) / sy * (H - 1) + 0.5).astype(np.int64)
    good = (px >= 0) & (px < W) & (py >= 0) & (py < H)

    n_use = max(1, int(len(px) * cfg.subsample_percent // 100))
    Z = _median_stack(
        jnp.asarray(np.clip(px, 0, W - 1), jnp.int32),
        jnp.asarray(np.clip(py, 0, H - 1), jnp.int32),
        jnp.asarray(mesh_aligned[2], jnp.float32),
        jnp.asarray(good),
        jax.random.PRNGKey(cfg.seed),
        (H, W),
        cfg.nreps,
        n_use,
    )
    Z = np.asarray(Z)

    if cfg.algorithm.upper() == "IDW":
        Zi, mask = idw_interpolate(Z)
    elif cfg.algorithm.upper() == "LINEARND":
        # Delaunay linear interpolation of the (subsampled) scattered
        # points (wassgridsurface.py:437-480); host scipy — the scattered
        # triangulation has no static, batched shape and this path exists
        # for reference parity.
        from scipy.interpolate import LinearNDInterpolator

        sel = np.flatnonzero(good)
        rng = np.random.default_rng(cfg.seed)
        rng.shuffle(sel)
        sel = sel[: max(int(sel.size * cfg.subsample_percent / 100.0), 4)]
        interp = LinearNDInterpolator(mesh_aligned[:2, sel].T, mesh_aligned[2, sel])
        Zi = interp(np.c_[setup.XX.ravel(), setup.YY.ravel()]).reshape(H, W)
        mask = np.isfinite(Zi).astype(np.float32)
        Zi = np.nan_to_num(Zi)
    else:
        Zi, mask = dct_interpolate(
            Z, nfreqs=cfg.dct_nfreqs, max_iters=cfg.dct_iters, alpha=cfg.dct_alpha, seed=cfg.seed
        )

    if user_mask is not None:
        mask = mask * user_mask
    Zi = np.where(mask > 0, Zi, np.nan)
    if cfg.median_filter_size >= 3:
        filled = np.nan_to_num(Zi)
        Zi = np.asarray(median_filter(jnp.asarray(filled, jnp.float32), cfg.median_filter_size))
        Zi = np.where(mask > 0, Zi, np.nan)
    if cfg.variational:
        # Photo-consistency polish against the undistorted frames
        # (the reference's experimental TFVariationalRefinement path).
        from wass_tpu.grid.variational import variational_refine

        I0 = workdir.load_undistorted(0).astype(np.float32)
        I1 = workdir.load_undistorted(1).astype(np.float32)
        P0cam, P1cam = workdir.load_projection_matrices()
        Zi = np.asarray(variational_refine(
            jnp.asarray(Zi, jnp.float32), I0, I1, P0cam, P1cam,
            setup.Rpl, setup.Tpl, setup.XX, setup.YY, setup.baseline,
            (mask > 0).astype(np.float32),
            max_iters=cfg.variational_iters, alpha=cfg.variational_alpha,
        ))
    return Zi, mask


@dataclasses.dataclass
class GridStats:
    """Streaming summary of a gridded sequence (grid_sequence no longer
    accumulates per-frame Z grids in host RAM — an hour of 20 Hz frames at
    512x512 would be ~38 GB)."""

    n_frames: int = 0
    zmin: float = float("nan")
    zmax: float = float("nan")
    zmean: Optional[np.ndarray] = None  # (H, W) temporal mean (meters)


def grid_sequence(
    workdirs: Sequence[Workdir],
    setup: GridSetup,
    out_path,
    cfg: GridConfig = GridConfig(),
    fps: Optional[float] = None,
    user_mask: Optional[np.ndarray] = None,
    diag_dir=None,
) -> GridStats:
    """Grid all frames into a NetCDF-compatible cube (gridded.nc schema).

    Streaming/out-of-core: each frame is gridded, pushed into the cube and
    dropped; only the running z statistics (a single (H, W) mean grid) stay
    resident.  Returns GridStats.  user_mask (reference --mask) is applied
    per frame and written into the cube's maskZ variable; diag_dir, when
    set, receives the reference's frame-0 diagnostic renders
    (gridded.png / grid_img.png, wassgridsurface.py:364-375)."""
    from wass_tpu.grid.netcdf import NetCDFWriter

    H, W = setup.XX.shape
    fps = fps if fps is not None else (setup.fps or 1.0)
    writer = NetCDFWriter(out_path, M=H, N=W)
    writer.scale = setup.baseline
    writer.set_grids(setup.XX * 1000.0, setup.YY * 1000.0)
    writer.set_kxky(setup.KX_ab, setup.KY_ab)
    writer.set_intrinsics(
        setup.K0, setup.K1, np.zeros(5), np.zeros(5),
        setup.P0plane, setup.P1plane, setup.P0cam[:3], setup.P1cam[:3],
        setup.Cam0toGrid, setup.Cam1toGrid,
    )
    writer.add_meta_attribute("generator", "wass_tpu")
    writer.add_meta_attribute("baseline", setup.baseline)
    writer.add_meta_attribute("fps", fps)
    writer.set_mask(
        np.ones((H, W), np.float32) if user_mask is None
        else np.asarray(user_mask, np.float32)
    )

    stats = GridStats()
    zsum = np.zeros((H, W), np.float64)
    zmin, zmax = np.inf, -np.inf
    for i, wd in enumerate(workdirs):
        Z, mask = grid_frame(wd, setup, cfg, user_mask=user_mask)
        frame_idx = int(str(wd.path.name)[:-3]) if str(wd.path.name).endswith("_wd") else i
        image = imagemask = None
        if cfg.save_images:
            image, imagemask, dims = _load_frame_jpeg(wd, cfg.image_id_to_save)
            if dims is not None:
                writer.add_meta_attribute("image_width", dims[1])
                writer.add_meta_attribute("image_height", dims[0])
        writer.push_Z(
            Z * 1000.0, time=i / fps, workdir=frame_idx,
            image=image, imagemask=imagemask,
        )
        if i == 0 and diag_dir is not None:
            _save_grid_diagnostics(Z, setup, diag_dir)
        zsum += np.nan_to_num(Z)
        zmin = min(zmin, float(np.nanmin(Z)))
        zmax = max(zmax, float(np.nanmax(Z)))
        stats.n_frames += 1

    # zmin/zmax/zmean provenance attributes (wassgridsurface.py:528-549).
    if stats.n_frames:
        stats.zmin, stats.zmax = zmin, zmax
        stats.zmean = zsum / stats.n_frames
        if cfg.force_zero_mean:
            writer.add_meta_attribute("zmin", zmin)
            writer.add_meta_attribute("zmax", -zmin)
            writer.add_meta_attribute("zmean", 0.0)
        else:
            writer.add_meta_attribute("zmin", zmin)
            writer.add_meta_attribute("zmax", zmax)
    writer.close()

    if cfg.force_zero_mean and stats.n_frames:
        _force_zero_mean_chunked(out_path, (stats.zmean * 1000.0).astype(np.float32))
    return stats


def _save_grid_diagnostics(Z: np.ndarray, setup: GridSetup, diag_dir) -> None:
    """Frame-0 renders: gridded.png (matplotlib surface) + grid_img.png
    (normalized grayscale), wassgridsurface.py:364-375."""
    try:
        from pathlib import Path

        diag = Path(diag_dir)
        diag.mkdir(parents=True, exist_ok=True)
        zmin, zmax = np.nanmin(Z), np.nanmax(Z)
        img = (Z - zmin) / max(zmax - zmin, 1e-12) * 255.0
        img = np.nan_to_num(img).astype(np.uint8)
        import imageio.v3 as iio

        iio.imwrite(diag / "grid_img.png", img)
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 8))
        plt.imshow(Z, vmin=zmin, vmax=zmax)
        plt.colorbar()
        fig.savefig(diag / "gridded.png", bbox_inches="tight")
        plt.close(fig)
    except Exception:
        pass


def _load_frame_jpeg(wd: Workdir, cam: int):
    """JPEG-encode the undistorted frame for the cube's cam0images
    variable (+ raw mask bytes when undistorted/maskN.png exists —
    wassgridsurface.py:494-513)."""
    try:
        from wass_tpu import native

        img = wd.load_undistorted(cam)
        if native.available():
            data = native.jpeg_encode(img)
        else:
            import io

            import imageio.v3 as iio

            buf = io.BytesIO()
            iio.imwrite(buf, np.clip(img, 0, 255).astype(np.uint8), extension=".jpg")
            data = buf.getvalue()
        maskfile = wd.path / "undistorted" / f"mask{cam}.png"
        imagemask = maskfile.read_bytes() if maskfile.exists() else None
        return data, imagemask, img.shape
    except Exception:
        return None, None, None


def _force_zero_mean_chunked(ncfile, mean_mm: np.ndarray) -> None:
    """Per-point temporal zero-mean as a chunked in-place rewrite
    (wassgridsurface.py:543-576: one h5py chunk read/subtract/write at a
    time — never the whole cube)."""
    import h5py

    meanT = mean_mm.T  # cube is stored (count, N=X, M=Y) = Z.T per frame
    with h5py.File(ncfile, "r+") as f:
        zv = f["Z"]
        for sl in zv.iter_chunks():
            zv[sl] = zv[sl] - meanT[sl[1], sl[2]]
