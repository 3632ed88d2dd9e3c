"""Optical-flow reconstruction path.

Equivalent of the reference's compile-time-optional dense flow stage
(`/root/reference/src/wass_stereo/wass_stereo.cpp:1391-1775`, enabled by
`WASS_ENABLE_OPTFLOW`, off by default in
`src/wass_stereo/CMakeLists.txt:5-8`): a coarse left<->right
correspondence field is densified, refined with a two-scale variational
(color-consistency + smoothness) solver, and the refined per-pixel
correspondences are triangulated into a second point cloud
(`mesh_full_flow.ply`).

Device-side redesign of each step:

* coarse flow (`refine_flow` KD-tree IDW, `wass_stereo.cpp:1592-1626`):
  the reference scatters sparse stereo correspondences into a KD-tree
  and IDW-interpolates per pixel.  Our dense stage already produces a
  *dense* rectified disparity, so the coarse flow is a pure gather:
  every undistorted base pixel maps through the rectifying homography,
  samples the disparity bilinearly, and maps back through the match
  inverse homography — no KD-tree, no scatter.
* hole fill: iterated masked-convolution IDW (same operator family as
  `gridding/wassgridsurface/IDWInterpolator.py`), vectorized over the
  two flow channels.
* variational refinement (`cv::optflow::VariationalRefinement`,
  `wass_stereo.cpp:1697-1745`): Horn-Schunck-style fixed-point solver —
  outer warp iterations linearize the color-consistency term
  (delta = FLOW_REFINEMENT_COLOR_CONSISTENCY_FACTOR), inner Jacobi
  sweeps under `lax.scan` solve the linearized system with smoothness
  alpha; run at 1/4 resolution then full resolution with the
  reference's two alpha values.
* correspondence gates + triangulation (`flow_to_points`
  `wass_stereo.cpp:1507-1556`, triangulation `:1722-1766`): masked
  elementwise gates and the batched linear-LSQ triangulator.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from wass_tpu.core.triangulate import triangulate_normalized
from wass_tpu.ops.sampling import bilinear_sample, resize


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """FLOW_* options (wass_stereo.cpp:78-83) under their reference
    semantics, plus solver iteration structure."""

    fullres_iterations: int = 200      # FLOW_REFINEMENT_FULLRES_ITERATIONS
    color_consistency: float = 100.0   # FLOW_REFINEMENT_COLOR_CONSISTENCY_FACTOR (delta)
    lowres_smoothness: float = 90.0    # FLOW_REFINEMENT_LOWRES_SMOOTHNESS_FACTOR (alpha)
    fullres_smoothness: float = 300.0  # FLOW_REFINEMENT_FULLRES_SMOOTHNESS_FACTOR
    opening_dilate: int = 1            # FLOW_OPENING_DILATE
    opening_erode: int = 1             # FLOW_OPENING_ERODE
    lowres_iterations: int = 1500      # fixed in the reference (:1704)
    inner_iterations: int = 25         # Jacobi sweeps per linearization
    idw_reps: int = 24                 # hole-fill passes (coarse flow)
    z_min: float = 1.0                 # accept gate on triangulated z (:1760)
    z_max: float = 100.0
    # The reference refines at 1/4 scale first because its coarse flow is
    # IDW-interpolated from *sparse* correspondences.  Our coarse flow is
    # already dense (stereo-seeded), so a single full-resolution
    # refinement is both cheaper and measurably more accurate — the
    # low-res pass only over-smooths an already-dense field.  Set
    # two_scale=True for the reference's schedule.
    two_scale: bool = False


# --------------------------------------------------------------------------
# Small local morphology on float masks (cv::dilate/erode 3x3, :1588-1589)
# --------------------------------------------------------------------------


def _shift2(x: jnp.ndarray, dy: int, dx: int, fill: float) -> jnp.ndarray:
    """Roll with the wrapped rows/columns reset to `fill`, so morphology
    never leaks across image borders (cv::dilate/erode replicate the
    border; fill = the op's neutral element gives the same result)."""
    x = jnp.roll(x, (dy, dx), axis=(0, 1))
    if dy > 0:
        x = x.at[:dy, :].set(fill)
    elif dy < 0:
        x = x.at[dy:, :].set(fill)
    if dx > 0:
        x = x.at[:, :dx].set(fill)
    elif dx < 0:
        x = x.at[:, dx:].set(fill)
    return x


def binary_dilate(mask: jnp.ndarray, steps: int) -> jnp.ndarray:
    for _ in range(steps):
        acc = mask
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = jnp.maximum(acc, _shift2(mask, dy, dx, 0.0))
        mask = acc
    return mask


def binary_erode(mask: jnp.ndarray, steps: int) -> jnp.ndarray:
    for _ in range(steps):
        acc = mask
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                acc = jnp.minimum(acc, _shift2(mask, dy, dx, 1.0))
        mask = acc
    return mask


# --------------------------------------------------------------------------
# Coarse flow from the rectified disparity (gather formulation)
# --------------------------------------------------------------------------


def coarse_flow_from_disparity(
    disp: jnp.ndarray,
    H_base: jnp.ndarray,
    Hi_match: jnp.ndarray,
    out_shape: Tuple[int, int],
    min_disp: float,
    valid_rect: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense coarse flow over the undistorted *base* image.

    For base pixel p: r = H_base p (rectified), d = disp(r),
    q = Hi_match (r - [d, 0]); flow(p) = q - p.  Returns (flow[H,W,2],
    valid[H,W]).  Replaces the reference's KD-tree IDW interpolation of
    sparse correspondences (wass_stereo.cpp:1592-1626) with a gather.

    valid_rect optionally restricts the seed correspondences to the dense
    stage's post-gate validity map (the reference seeds its flow KD-tree
    from the triangulation loop where every gate passed, :1280).
    """
    H, W = out_shape
    Hr, Wr = disp.shape
    xx = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
    ones = jnp.ones_like(xx)
    p = jnp.stack([xx, yy, ones], -1)
    r = p @ H_base.T
    rx = r[..., 0] / r[..., 2]
    ry = r[..., 1] / r[..., 2]

    d = bilinear_sample(disp, rx, ry, fill=0.0)
    okmap = (disp > min_disp)
    if valid_rect is not None:
        okmap = okmap & valid_rect
    ok = bilinear_sample(okmap.astype(jnp.float32), rx, ry, fill=0.0)
    inb = (rx >= 0) & (rx <= Wr - 1) & (ry >= 0) & (ry <= Hr - 1)
    valid = (ok > 0.999) & inb & (d > min_disp)

    m = jnp.stack([rx - d, ry, jnp.ones_like(rx)], -1) @ Hi_match.T
    qx = m[..., 0] / m[..., 2]
    qy = m[..., 1] / m[..., 2]
    flow = jnp.stack([qx - xx, qy - yy], -1)
    flow = jnp.where(valid[..., None], flow, 0.0)
    return flow, valid


def idw_fill(flow: jnp.ndarray, valid: jnp.ndarray, reps: int = 24) -> jnp.ndarray:
    """Fill invalid flow pixels by iterated masked 3x3 averaging (the
    conv-IDW operator; each pass grows the support by one pixel)."""
    k = jnp.ones((3, 3), jnp.float32)

    def conv(x):
        return jax.lax.conv_general_dilated(
            x[None, None], k[None, None], (1, 1), "SAME"
        )[0, 0]

    f = flow * valid[..., None]
    m = valid.astype(jnp.float32)

    def body(_, state):
        f, m = state
        num0 = conv(f[..., 0])
        num1 = conv(f[..., 1])
        den = conv(m)
        fill0 = num0 / jnp.maximum(den, 1e-6)
        fill1 = num1 / jnp.maximum(den, 1e-6)
        newm = (den > 0).astype(jnp.float32)
        f0 = jnp.where(m > 0, f[..., 0], fill0)
        f1 = jnp.where(m > 0, f[..., 1], fill1)
        return jnp.stack([f0, f1], -1), jnp.maximum(m, newm)

    f, m = jax.lax.fori_loop(0, reps, body, (f, m))
    return f


# --------------------------------------------------------------------------
# Variational refinement (Horn-Schunck fixed point with warping)
# --------------------------------------------------------------------------


def _avg_kernel() -> jnp.ndarray:
    # Horn-Schunck neighborhood average (4-neighbor weighted).
    return jnp.array(
        [[1 / 12, 1 / 6, 1 / 12], [1 / 6, 0.0, 1 / 6], [1 / 12, 1 / 6, 1 / 12]],
        jnp.float32,
    )


def _conv_same(x: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.conv_general_dilated(x[None, None], k[None, None], (1, 1), "SAME")[0, 0]


def _image_grads(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    gx = (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1)) * 0.5
    gy = (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0)) * 0.5
    return gx, gy


@partial(jax.jit, static_argnames=("outer", "inner"))
def variational_refine(
    I0: jnp.ndarray,
    I1: jnp.ndarray,
    flow: jnp.ndarray,
    alpha: float,
    delta: float,
    outer: int,
    inner: int,
) -> jnp.ndarray:
    """Refine flow so that I1(p + flow(p)) ~ I0(p).

    Energy (cv::VariationalRefinement semantics, gamma=0):
      E = sum delta * rho(I1(p+w) - I0(p)) + alpha * |grad w|^2
    Outer iterations re-warp and linearize the data term; inner Jacobi
    sweeps update the flow under `lax.scan`.  rho is Charbonnier
    (robust), matching the reference solver's robust penalties.
    """
    H, W = I0.shape
    xx = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
    kavg = _avg_kernel()
    lam = alpha / jnp.maximum(delta, 1e-6)
    eps2 = 1e-3

    u = flow[..., 0]
    v = flow[..., 1]

    g1x_full, g1y_full = _image_grads(I1)

    def outer_body(carry, _):
        u, v = carry
        px = xx + u
        py = yy + v
        I1w = bilinear_sample(I1, px, py, fill=0.0)
        Ix = bilinear_sample(g1x_full, px, py, fill=0.0)
        Iy = bilinear_sample(g1y_full, px, py, fill=0.0)
        It = I1w - I0
        inb = ((px >= 1) & (px <= W - 2) & (py >= 1) & (py <= H - 2)).astype(jnp.float32)
        # Robust data weight (Charbonnier derivative / residual).
        wdata = inb / jnp.sqrt(It * It + eps2)
        u0, v0 = u, v

        def jacobi(carry, _):
            u, v = carry
            ubar = _conv_same(u, kavg)
            vbar = _conv_same(v, kavg)
            # Linearized residual at (ubar, vbar) around warp point (u0, v0).
            r = It + Ix * (ubar - u0) + Iy * (vbar - v0)
            den = lam + wdata * (Ix * Ix + Iy * Iy)
            un = ubar - wdata * Ix * r / den
            vn = vbar - wdata * Iy * r / den
            return (un, vn), None

        (u, v), _ = jax.lax.scan(jacobi, (u, v), None, length=inner)
        return (u, v), None

    (u, v), _ = jax.lax.scan(outer_body, (u, v), None, length=outer)
    return jnp.stack([u, v], -1)


def refine_flow_two_scale(
    I0: jnp.ndarray, I1: jnp.ndarray, flow: jnp.ndarray, cfg: FlowConfig
) -> jnp.ndarray:
    """The reference's two-scale schedule (wass_stereo.cpp:1709-1738):
    quarter-resolution refinement with `lowres_smoothness`, upsample x4,
    full-resolution refinement with `fullres_smoothness`."""
    H, W = I0.shape
    h4, w4 = max(H // 4, 8), max(W // 4, 8)
    I0s = resize(I0, (h4, w4), interp="linear")
    I1s = resize(I1, (h4, w4), interp="linear")
    sy = h4 / H
    sx = w4 / W
    fs = jnp.stack(
        [
            resize(flow[..., 0], (h4, w4), interp="linear") * sx,
            resize(flow[..., 1], (h4, w4), interp="linear") * sy,
        ],
        -1,
    )
    outer_low = max(1, cfg.lowres_iterations // (cfg.inner_iterations * 4))
    fs = variational_refine(
        I0s, I1s, fs, cfg.lowres_smoothness, cfg.color_consistency,
        outer=outer_low, inner=cfg.inner_iterations,
    )
    flow_up = jnp.stack(
        [
            resize(fs[..., 0], (H, W), interp="linear") / sx,
            resize(fs[..., 1], (H, W), interp="linear") / sy,
        ],
        -1,
    )
    outer_full = max(1, cfg.fullres_iterations // cfg.inner_iterations)
    return variational_refine(
        I0, I1, flow_up, cfg.fullres_smoothness, cfg.color_consistency,
        outer=outer_full, inner=cfg.inner_iterations,
    )


# --------------------------------------------------------------------------
# Correspondence gates + triangulation (flow_to_points, :1507-1556)
# --------------------------------------------------------------------------


def flow_correspondence_gates(
    flow: jnp.ndarray,
    mask: jnp.ndarray,
    I_base: jnp.ndarray,
    I_match: jnp.ndarray,
) -> jnp.ndarray:
    """The reference's per-pixel acceptance gates: finite flow, magnitude
    < W/2, opened mask, target inside the match image, both intensities
    nonzero."""
    H, W = I_base.shape
    xx = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
    qx = xx + flow[..., 0]
    qy = yy + flow[..., 1]
    mag = jnp.linalg.norm(flow, axis=-1)
    ok = jnp.isfinite(mag) & (mag < W / 2) & (mask > 0)
    ok = ok & (qx > 0) & (qx < W) & (qy > 0) & (qy < H)
    match_at = bilinear_sample(I_match, qx, qy, fill=0.0)
    ok = ok & (I_base > 0) & (match_at > 0)
    return ok


def triangulate_flow(
    flow: jnp.ndarray,
    valid: jnp.ndarray,
    K0: jnp.ndarray,
    K1: jnp.ndarray,
    R: jnp.ndarray,
    T: jnp.ndarray,
    base_is_cam0,
    cfg: FlowConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Triangulate base->match flow correspondences.  Returns cam0-frame
    points (H, W, 3) + validity with the reference's z gates (:1758-1761)."""
    H, W = valid.shape
    xx = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
    uv_base = jnp.stack([xx, yy], -1)
    uv_match = uv_base + flow

    uv0 = jnp.where(base_is_cam0, uv_base, uv_match)
    uv1 = jnp.where(base_is_cam0, uv_match, uv_base)
    p = jnp.stack(
        [(uv0[..., 0] - K0[0, 2]) / K0[0, 0], (uv0[..., 1] - K0[1, 2]) / K0[1, 1]], -1
    )
    q = jnp.stack(
        [(uv1[..., 0] - K1[0, 2]) / K1[0, 0], (uv1[..., 1] - K1[1, 2]) / K1[1, 1]], -1
    )
    pts = triangulate_normalized(p, q, R, T)
    valid = valid & (pts[..., 2] >= cfg.z_min) & (pts[..., 2] <= cfg.z_max)
    return pts, valid


# --------------------------------------------------------------------------
# Host driver
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FlowResult:
    flow: np.ndarray          # (H, W, 2) refined base->match flow
    coarse_flow: np.ndarray   # (H, W, 2) pre-refinement flow
    points: np.ndarray        # (H, W, 3) cam0-frame triangulated points
    valid: np.ndarray         # (H, W) bool


def flow_reconstruct_frame(
    disp,
    base_img,
    match_img,
    geom,
    cfg: FlowConfig = FlowConfig(),
    min_disp: float = 1.0,
    valid_rect=None,
    max_refine_deviation: float = 4.0,
) -> FlowResult:
    """Full flow stage for one frame (refine_flow, wass_stereo.cpp:1580-1773).

    Args:
      disp: rectified disparity map (device or numpy array).
      base_img/match_img: *undistorted* base/match images (the flow works
        in unrectified space like the reference's env.right/env.left).
      geom: FrameGeometry from prepare_frame_geometry.
      valid_rect: optional rectified-space validity (DenseFrameResult.valid)
        restricting the coarse correspondences to post-gate pixels.
      max_refine_deviation: reject pixels whose refined flow moved more
        than this many px away from the stereo-seeded coarse flow — the
        refinement is a *refinement*, not a re-match; large deviations are
        drift in textureless areas.
    """
    H, W = base_img.shape
    disp = jnp.asarray(disp, jnp.float32)
    I0 = jnp.asarray(base_img, jnp.float32)
    I1 = jnp.asarray(match_img, jnp.float32)

    flow, valid = coarse_flow_from_disparity(
        disp,
        jnp.asarray(geom.H_base, jnp.float32),
        jnp.asarray(geom.Hi_match, jnp.float32),
        (H, W),
        min_disp,
        valid_rect=None if valid_rect is None else jnp.asarray(valid_rect),
    )
    mask = binary_erode(
        binary_dilate(valid.astype(jnp.float32), cfg.opening_dilate),
        cfg.opening_erode,
    )
    coarse = idw_fill(flow, valid, reps=cfg.idw_reps)
    if cfg.two_scale:
        refined = refine_flow_two_scale(I0, I1, coarse, cfg)
    else:
        outer = max(1, cfg.fullres_iterations // cfg.inner_iterations)
        refined = variational_refine(
            I0, I1, coarse, cfg.fullres_smoothness, cfg.color_consistency,
            outer=outer, inner=cfg.inner_iterations,
        )

    ok = flow_correspondence_gates(refined, mask, I0, I1)
    dev = jnp.linalg.norm(refined - coarse, axis=-1)
    ok = ok & (dev <= max_refine_deviation)
    pts, ok = triangulate_flow(
        refined,
        ok,
        jnp.asarray(geom.K0, jnp.float32),
        jnp.asarray(geom.K1, jnp.float32),
        jnp.asarray(geom.R, jnp.float32),
        jnp.asarray(geom.T, jnp.float32),
        bool(geom.base_is_cam0),
        cfg,
    )
    return FlowResult(
        flow=np.asarray(refined),
        coarse_flow=np.asarray(coarse),
        points=np.asarray(pts),
        valid=np.asarray(ok),
    )
