"""Synthetic wave-field stereo scenes with exact ground truth.

The reference's golden-test strategy renders synthetic scenes from known
geometry and asserts recovery (WASS_TEST synthetic sequence,
/root/reference/doc/src/render/documentation/testing.html.md:14-110, and the
random-camera self-test in
/root/reference/src/wass_stereo/stereorectify.cpp:247-364).  This module is
our generator: a procedural directional-wave height field textured with
multi-octave value noise, ray-traced from two pinhole cameras with known
K / R / T, returning images plus exact per-pixel ground truth.

World frame: sea mean plane is z_w = 0, +z up.  Cameras sit at height
`cam_height` looking down at `look_down_deg` below the horizon, separated
by a unit-norm-ish baseline — mirroring the reference design point (5 MP,
~10 m elevation, ~20 deg depression, stereo.html.md:13-16).  All outputs are
expressed in the camera-0 frame like the WASS pipeline (extrinsics R, T with
x_cam1 = R x_cam0 + T).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Procedural fields
# --------------------------------------------------------------------------


def _value_noise(rng: np.random.Generator, n_octaves: int = 5, base: int = 8):
    """Multi-octave value noise on [0,1]^2 -> callable(x, y) in [0, 1]."""
    grids = []
    for o in range(n_octaves):
        res = base * (2**o)
        grids.append((res, rng.random((res + 2, res + 2)), 0.55**o))

    def sample(x, y):
        out = np.zeros_like(x, dtype=np.float64)
        norm = 0.0
        for res, g, amp in grids:
            fx = (x % 1.0) * res
            fy = (y % 1.0) * res
            ix = np.clip(fx.astype(np.int64), 0, res)
            iy = np.clip(fy.astype(np.int64), 0, res)
            tx = fx - ix
            ty = fy - iy
            tx = tx * tx * (3 - 2 * tx)
            ty = ty * ty * (3 - 2 * ty)
            v00 = g[iy, ix]
            v01 = g[iy, ix + 1]
            v10 = g[iy + 1, ix]
            v11 = g[iy + 1, ix + 1]
            out += amp * ((v00 * (1 - tx) + v01 * tx) * (1 - ty) + (v10 * (1 - tx) + v11 * tx) * ty)
            norm += amp
        return out / norm

    sample.grids = grids
    return sample


@dataclasses.dataclass
class WaveField:
    """Sum-of-sinusoids directional sea surface z = eta(x, y)."""

    amps: np.ndarray
    kx: np.ndarray
    ky: np.ndarray
    phases: np.ndarray

    @staticmethod
    def random(rng: np.random.Generator, amplitude: float = 0.08, n_waves: int = 24, kmin: float = 0.05, kmax: float = 1.2):
        k = np.exp(rng.uniform(np.log(kmin), np.log(kmax), n_waves))
        theta = rng.normal(0.0, 0.6, n_waves)
        # Longer waves carry more energy (omnidirectional-ish spectrum);
        # scaled so std(eta) == amplitude.
        amps = (kmin / k) ** 0.8
        amps *= amplitude / np.sqrt(np.sum(0.5 * amps**2) + 1e-30)
        return WaveField(
            amps=amps,
            kx=k * np.cos(theta),
            ky=k * np.sin(theta),
            phases=rng.uniform(0, 2 * np.pi, n_waves),
        )

    def eta(self, x: np.ndarray, y: np.ndarray, t: float = 0.0) -> np.ndarray:
        out = np.zeros_like(x, dtype=np.float64)
        for a, kx, ky, ph in zip(self.amps, self.kx, self.ky, self.phases):
            omega = np.sqrt(9.81 * np.hypot(kx, ky))
            out += a * np.cos(kx * x + ky * y + ph - omega * t)
        return out


# --------------------------------------------------------------------------
# Rig
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SyntheticRig:
    """Two pinhole cameras in the world frame."""

    K0: np.ndarray
    K1: np.ndarray
    R0: np.ndarray  # world -> cam0
    T0: np.ndarray
    R1: np.ndarray  # world -> cam1
    T1: np.ndarray
    width: int
    height: int
    dist0: Optional[np.ndarray] = None
    dist1: Optional[np.ndarray] = None

    @property
    def R(self) -> np.ndarray:
        """Relative rotation: x_cam1 = R x_cam0 + T."""
        return self.R1 @ self.R0.T

    @property
    def T(self) -> np.ndarray:
        return self.T1 - self.R @ self.T0

    @property
    def baseline(self) -> float:
        return float(np.linalg.norm(self.T))

    def plane_cam0(self) -> np.ndarray:
        """Sea mean plane (z_w = 0) as (a, b, c, d) in cam0 coords with the
        normal facing the camera (+z component, matching PovMesh convention)."""
        n_w = np.array([0.0, 0.0, 1.0])
        n_c = self.R0 @ n_w
        # plane: n_c . x_c + d = 0 for x_c = R0 x_w + T0 with n_w . x_w = 0
        d = -float(n_c @ self.T0)
        if n_c[2] < 0:
            n_c, d = -n_c, -d
        return np.array([n_c[0], n_c[1], n_c[2], d])


def make_rig(
    width: int = 256,
    height: int = 192,
    focal_px: Optional[float] = None,
    cam_height: float = 10.0,
    look_down_deg: float = 25.0,
    baseline: float = 2.5,
    toe_in_deg: float = 1.0,
) -> SyntheticRig:
    # Deterministic: the principal-point jitters below are fixed, so every
    # call with the same arguments produces the identical canonical rig.
    f = focal_px if focal_px is not None else 1.1 * width
    K = lambda jx, jy: np.array(
        [[f, 0.0, width / 2 + jx], [0.0, f, height / 2 + jy], [0.0, 0.0, 1.0]]
    )

    def look(cam_pos, down_deg, yaw_deg):
        """world->cam rotation for a camera looking +y (north), pitched down."""
        cp = np.deg2rad(down_deg)
        cy = np.deg2rad(yaw_deg)
        # camera axes in world coords: x right, y down-ish, z forward
        fwd = np.array([np.sin(cy) * np.cos(cp), np.cos(cy) * np.cos(cp), -np.sin(cp)])
        right = np.array([np.cos(cy), -np.sin(cy), 0.0])
        down = np.cross(fwd, right)
        Rwc = np.stack([right, down, fwd])  # rows = cam axes
        t = -Rwc @ cam_pos
        return Rwc, t

    p0 = np.array([-baseline / 2, 0.0, cam_height])
    p1 = np.array([+baseline / 2, 0.0, cam_height])
    R0, T0 = look(p0, look_down_deg, +toe_in_deg)
    R1, T1 = look(p1, look_down_deg, -toe_in_deg)
    return SyntheticRig(K(0.5, -0.3), K(-0.4, 0.2), R0, T0, R1, T1, width, height)


# --------------------------------------------------------------------------
# Rendering
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SyntheticScene:
    rig: SyntheticRig
    waves: WaveField
    img0: np.ndarray  # (H, W) float in [0, 255]
    img1: np.ndarray
    depth0: np.ndarray  # per-pixel z in cam0 frame (nan where no hit)
    points0: np.ndarray  # (H, W, 3) per-pixel 3D points in cam0 frame
    texture_scale: float

    def eta_cam0(self, pts_cam0: np.ndarray) -> np.ndarray:
        """Ground-truth world elevation for cam0-frame points (for error
        metrics): returns eta(x_w, y_w) - z_w (0 for exact surface points)."""
        R0, T0 = self.rig.R0, self.rig.T0
        pw = (pts_cam0 - T0) @ R0
        return self.waves.eta(pw[..., 0], pw[..., 1]) - pw[..., 2]

    def elevation_error(self, pts_cam0: np.ndarray, plane: np.ndarray) -> np.ndarray:
        """verify_meshes.m-style elevation error (reference
        /root/reference/test/verify_meshes.m:14-30): both the reconstructed
        points and the ground truth are aligned to the *same estimated* sea
        plane, so global calibration tilt cancels exactly as in the
        reference's acceptance test.

        Args:
          pts_cam0: (N, 3) reconstructed points, cam0 frame, baseline units.
          plane: (4,) estimated plane (cam0 frame, baseline units).
        Returns per-point |z_rec - z_gt| in baseline units (NaN where the
        point projects outside the image).
        """
        K0 = self.rig.K0
        b = self.rig.baseline
        # Ground-truth 3D point along the same cam0 ray: sample the GT
        # point map at the reconstructed point's projection.
        uv = pts_cam0 @ K0.T
        uv = uv[:, :2] / uv[:, 2:3]
        H, W = self.depth0.shape
        x = np.clip(uv[:, 0], 0, W - 1.001)
        y = np.clip(uv[:, 1], 0, H - 1.001)
        x0 = np.floor(x).astype(int)
        y0 = np.floor(y).astype(int)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        P = self.points0
        gt = (
            P[y0, x0] * (1 - fx) * (1 - fy)
            + P[y0, x0 + 1] * fx * (1 - fy)
            + P[y0 + 1, x0] * (1 - fx) * fy
            + P[y0 + 1, x0 + 1] * fx * fy
        ) / b
        inb = (uv[:, 0] >= 0) & (uv[:, 0] < W - 1) & (uv[:, 1] >= 0) & (uv[:, 1] < H - 1)

        # Align both clouds by the same estimated plane (plane frame z).
        a, bb, c, d = plane
        n = np.array([a, bb, c])
        z_rec = pts_cam0 @ n + d
        z_gt = gt @ n + d
        err = np.abs(z_rec - z_gt)
        return np.where(inb, err, np.nan)


def _trace_rays(origin: np.ndarray, dirs: np.ndarray, waves: WaveField, iters: int = 30):
    """Intersect rays origin + t*dirs with z = eta(x, y); returns t (nan if
    pointing away from the surface)."""
    vz = dirs[..., 2]
    # Initial guess: intersection with the mean plane.
    with np.errstate(divide="ignore", invalid="ignore"):
        t = -origin[2] / vz
    bad = (vz >= -1e-6) | (t <= 0)
    t = np.where(bad, np.nan, t)
    for _ in range(iters):
        p = origin[None, None, :] + t[..., None] * dirs
        h = waves.eta(p[..., 0], p[..., 1])
        # Move along the ray to the surface elevation at the current (x, y).
        t = t + (h - p[..., 2]) / vz
    return t


def add_offband_object(img0: np.ndarray, img1: np.ndarray, y0: int, x0: int,
                       size: int, disparity: int, seed: int = 0) -> None:
    """Paste one textured square (a buoy or boat close to the rig) into a
    pair in place: at column x0 in img0 and x0 - disparity in img1, i.e. at
    a disparity far outside the sea's band on those rows.  The texture is
    blocky (8 px cells) so it survives the coarse pass's pooling."""
    cells = np.random.default_rng(seed).uniform(20, 230, (size // 8, size // 8))
    tex = np.kron(cells, np.ones((8, 8))).astype(img0.dtype)
    s = tex.shape[0]
    img0[y0 : y0 + s, x0 : x0 + s] = tex
    img1[y0 : y0 + s, x0 - disparity : x0 - disparity + s] = tex


def _render_device(rig, waves, grids, tex_scale, K, Rwc, t, iters: int = 30):
    """render() of make_scene as one float32 JAX program on the default
    device: same rays, same fixed-point iteration, same texture lookups.
    Returns (img, points in this camera's frame) as numpy arrays."""
    import jax
    import jax.numpy as jnp

    H, W = rig.height, rig.width
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float64), jnp.float32)
    amps, kx, ky, ph = (f32(a) for a in (waves.amps, waves.kx, waves.ky, waves.phases))
    cam_pos = -Rwc.T @ t

    def eta(x, y):
        arg = kx * x[..., None] + ky * y[..., None] + ph
        return jnp.sum(amps * jnp.cos(arg), axis=-1)

    def tex(x, y):
        out = jnp.zeros_like(x)
        norm = 0.0
        for res, g, amp in grids:
            g = f32(g)
            fx = (x % 1.0) * res
            fy = (y % 1.0) * res
            ix = jnp.clip(fx.astype(jnp.int32), 0, res)
            iy = jnp.clip(fy.astype(jnp.int32), 0, res)
            tx = fx - ix
            ty = fy - iy
            tx = tx * tx * (3 - 2 * tx)
            ty = ty * ty * (3 - 2 * ty)
            v00, v01 = g[iy, ix], g[iy, ix + 1]
            v10, v11 = g[iy + 1, ix], g[iy + 1, ix + 1]
            out = out + amp * ((v00 * (1 - tx) + v01 * tx) * (1 - ty) + (v10 * (1 - tx) + v11 * tx) * ty)
            norm += amp
        return out / norm

    @jax.jit
    def render(Kd, Rd, td, cpos):
        vv, uu = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32), indexing="ij")
        rays = jnp.stack([(uu - Kd[0, 2]) / Kd[0, 0], (vv - Kd[1, 2]) / Kd[1, 1], jnp.ones_like(uu)], -1)
        rays = rays @ Rd
        rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
        vz = rays[..., 2]
        t0 = -cpos[2] / vz
        tr = jnp.where((vz >= -1e-6) | (t0 <= 0), jnp.nan, t0)

        def body(_, tr):
            p = cpos + tr[..., None] * rays
            return tr + (eta(p[..., 0], p[..., 1]) - p[..., 2]) / vz

        tr = jax.lax.fori_loop(0, iters, body, tr)
        pw = cpos + tr[..., None] * rays
        img = 30.0 + 200.0 * tex(pw[..., 0] * tex_scale, pw[..., 1] * tex_scale)
        img = jnp.clip(jnp.where(jnp.isfinite(tr), img, 0.0), 0, 255)
        return img, pw @ Rd.T + td

    with jax.default_matmul_precision("highest"):
        img, pc = render(f32(K), f32(Rwc), f32(t), f32(cam_pos))
    return np.asarray(img), np.asarray(pc, np.float64)


def make_scene(
    seed: int = 0,
    width: int = 256,
    height: int = 192,
    wave_amplitude: float = 0.08,
    time: float = 0.0,
    rig: Optional[SyntheticRig] = None,
    texture_octaves: int = 7,
    on_device: bool = False,
) -> SyntheticScene:
    """Render a stereo pair of a random sea from `seed`.

    on_device=True renders in float32 on JAX's default device (seconds at
    megapixel sizes, where the float64 numpy render takes minutes); the
    scene, rig and ground-truth contract are the same.
    """
    rng = np.random.default_rng(seed)
    rig = rig or make_rig(width=width, height=height)
    waves = WaveField.random(rng, amplitude=wave_amplitude)
    # Texture field over world xy; scale chosen so the finest octave is a few
    # pixels on screen at the working distance.
    tex = _value_noise(rng, n_octaves=texture_octaves, base=8)
    tex_scale = 1.0 / 60.0  # world units -> texture units

    if on_device:
        img0, pc0 = _render_device(rig, waves, tex.grids, tex_scale, rig.K0, rig.R0, rig.T0)
        img1, _ = _render_device(rig, waves, tex.grids, tex_scale, rig.K1, rig.R1, rig.T1)
        return SyntheticScene(
            rig=rig, waves=waves, img0=img0.astype(np.float32),
            img1=img1.astype(np.float32), depth0=pc0[..., 2], points0=pc0,
            texture_scale=tex_scale,
        )

    def render(K, Rwc, t):
        H, W = rig.height, rig.width
        cam_pos = -Rwc.T @ t
        u = np.arange(W, dtype=np.float64)
        v = np.arange(H, dtype=np.float64)
        uu, vv = np.meshgrid(u, v)
        rays_cam = np.stack(
            [(uu - K[0, 2]) / K[0, 0], (vv - K[1, 2]) / K[1, 1], np.ones_like(uu)], axis=-1
        )
        rays_w = rays_cam @ Rwc  # R^T @ ray
        rays_w /= np.linalg.norm(rays_w, axis=-1, keepdims=True)
        tt = _trace_rays(cam_pos, rays_w, waves)
        pw = cam_pos[None, None, :] + tt[..., None] * rays_w
        # Shading: texture + slope-dependent lambert-ish term for realism.
        base = tex(pw[..., 0] * tex_scale, pw[..., 1] * tex_scale)
        img = 30.0 + 200.0 * base
        img = np.where(np.isfinite(tt), img, 0.0)
        pc = pw @ Rwc.T + t  # points in this camera's frame
        return np.clip(img, 0, 255), pc, pw

    img0, pc0, pw0 = render(rig.K0, rig.R0, rig.T0)
    img1, _, _ = render(rig.K1, rig.R1, rig.T1)
    depth0 = pc0[..., 2]
    return SyntheticScene(
        rig=rig,
        waves=waves,
        img0=img0.astype(np.float32),
        img1=img1.astype(np.float32),
        depth0=depth0,
        points0=pc0,
        texture_scale=tex_scale,
    )
