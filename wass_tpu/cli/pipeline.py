"""Sequence-level pipeline orchestration (the wasscli equivalent).

Replaces the reference's interactive driver
(/root/reference/cli/wasscli/wasscli.py): prepare every frame pair, match
a random subset of frames (:259, <= 50), run the sequence-wide
autocalibration reduction, then dense stereo on every frame, aggregating
per-frame planes into output/planes.txt (:320-343).

The reference parallelizes with 4 worker processes over a shared
filesystem; here each stage is already a batched device program, frames
stream through one process (and shard across devices/hosts via
wass_tpu.parallel when available).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from wass_tpu.io.workdir import Workdir, frame_workdirs
from wass_tpu.prepare.prepare import PrepareConfig, prepare_frame
from wass_tpu.match.pipeline import MatchConfig, match_frame
from wass_tpu.calib.autocalibrate import AutocalConfig, autocalibrate_sequence
from wass_tpu.stereo.dense import (
    DenseStereoConfig,
    DenseStereoPipeline,
    build_geom_pack,
    prepare_frame_geometry,
    rectify_on_device,
)
from wass_tpu.core.geometry import rt_from_plane


@dataclasses.dataclass
class SequenceConfig:
    prepare: PrepareConfig = dataclasses.field(default_factory=PrepareConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    autocal: AutocalConfig = dataclasses.field(default_factory=AutocalConfig)
    stereo: DenseStereoConfig = dataclasses.field(default_factory=DenseStereoConfig)
    match_subset: int = 50  # wasscli.py:259
    seed: int = 0
    # Optical-flow reconstruction path (reference: WASS_ENABLE_OPTFLOW
    # compile-time option, off by default).  Set to a FlowConfig to enable.
    flow: Optional[object] = None
    # Production-loop knobs.  The reference overlaps work with 4 worker
    # processes over NFS (wasscli.py:48,346); here one process pipelines:
    # PNG decode in native prefetch threads, device work dispatched
    # dispatch_depth frames ahead (no per-frame host sync), and
    # finalization (device fetch + mesh export + debug renders) in
    # writer threads.
    dispatch_depth: int = 3
    writer_threads: int = 2
    # The reference's always-on stereo debug artifact set (stereo.jpg,
    # disparity renders, coverage, component map — wass_stereo.cpp:854,
    # 1001,1017,1910-1926, PovMesh.cpp:982-984).
    debug_renders: bool = True
    # Delta-code the .xyzC wire payload (3 bytes/point + u16 exception
    # rows instead of 6 bytes/point; byte-identical file after the host
    # decode).  Real disparity maps carry 20-30% exception points
    # (speckled invalid gaps), so the wire saving is ~1.5 bytes/point,
    # which wins only when the host decodes faster than the link ships
    # those bytes (slow-link + fast-host; on a PCIe host the direct
    # fetch costs ~2 ms and delta is moot).  None = AUTO (default):
    # probe the device download bandwidth and the host decode rate once
    # per sequence and pick the faster path (both sides of the decision
    # are per-point, so frame size cancels).  True/False force it.
    wire_delta: Optional[bool] = None


class SequencePipeline:
    def __init__(self, outdir, cfg: Optional[SequenceConfig] = None):
        self.outdir = Path(outdir)
        self.cfg = cfg or SequenceConfig()
        self.outdir.mkdir(parents=True, exist_ok=True)

    # -- stage 1: prepare --------------------------------------------------
    def prepare(self, frames, K0, d0, K1, d1, ext_R=None, ext_T=None) -> List[Workdir]:
        """frames: iterable of (img0, img1) raw grayscale arrays."""
        wds = []
        for i, (img0, img1) in enumerate(frames):
            wd_path = self.outdir / f"{i:06d}_wd"
            wd = prepare_frame(wd_path, img0, img1, K0, d0, K1, d1, self.cfg.prepare, ext_R, ext_T)
            wds.append(wd)
        return wds

    def workdirs(self) -> List[Workdir]:
        return frame_workdirs(self.outdir)

    # -- stage 2: match ----------------------------------------------------
    def match(self, wds: Optional[Sequence[Workdir]] = None) -> int:
        wds = list(wds if wds is not None else self.workdirs())
        rng = np.random.default_rng(self.cfg.seed)
        if len(wds) > self.cfg.match_subset:
            sel = rng.choice(len(wds), self.cfg.match_subset, replace=False)
            wds = [wds[i] for i in sorted(sel)]
        n_ok = 0
        for wd in wds:
            import time as _time

            t0 = _time.time()
            img0 = wd.load_undistorted(0)
            img1 = wd.load_undistorted(1)
            K0 = wd.load_intrinsics(0)
            K1 = wd.load_intrinsics(1)
            res = match_frame(img0, img1, K0, K1, self.cfg.match)
            # Per-stage logfile (the wass_stereo_log.txt analogue for the
            # match stage; the reference logs this stage to stdout only).
            with open(wd.path / "wass_match_log.txt", "w") as f:
                if res is None:
                    f.write("[ERROR] match stage failed (no pose recovered)\n")
                else:
                    f.write(f"[INFO] matches: {res.n_matches}\n")
                    f.write(
                        f"[INFO] epipolar error avg/std/min/max: "
                        f"{res.epi_avg:.4f} {res.epi_std:.4f} "
                        f"{res.epi_min:.4f} {res.epi_max:.4f} px\n"
                    )
                f.write(f"[INFO] wall time: {_time.time()-t0:.3f}s\n")
            if res is None:
                continue
            wd.save_extrinsics(res.R, res.T)
            wd.save_matches("matches.txt", res.uv0_pose, res.uv1_pose)
            wd.save_matches("matches_epionly.txt", res.uv0_epi, res.uv1_epi)
            wd.save_matches("matches_unfiltered.txt", res.uv0_all, res.uv1_all)
            wd.save_matcher_stats(res.n_matches, res.epi_avg, res.epi_std, res.epi_min, res.epi_max)
            try:
                from wass_tpu.utils.render import render_matches

                render_matches(wd.path / "matches.jpg", img0, img1, res.uv0_pose, res.uv1_pose)
                render_matches(wd.path / "matches_epifilter.jpg", img0, img1, res.uv0_epi, res.uv1_epi)
            except Exception:
                pass  # debug imagery must never fail the stage
            n_ok += 1
        return n_ok

    # -- stage 3: autocalibrate -------------------------------------------
    def autocalibrate(self):
        import time as _time

        t0 = _time.time()
        res = autocalibrate_sequence(self.workdirs(), self.cfg.autocal)
        # Sequence-level logfile (the reference logs this stage to stdout
        # only; wass_stereo sets the per-stage precedent, :1833).
        with open(self.outdir / "wass_autocalibrate_log.txt", "w") as f:
            if res is None:
                f.write("[ERROR] autocalibrate failed (no pooled matches)\n")
            else:
                f.write(f"[INFO] pooled inliers: {res.n_inliers}\n")
                f.write(
                    f"[INFO] median epipolar error before/after BA: "
                    f"{res.epi_med_before:.6f} / {res.epi_med_after:.6f} px\n"
                )
                f.write(f"[INFO] accepted (improved): {res.improved}\n")
            f.write(f"[INFO] wall time: {_time.time()-t0:.3f}s\n")
        return res

    # -- stage 4: dense stereo --------------------------------------------
    def _frame_geometry(self, cache: dict, K0, K1, R, T, shape):
        """Geometry + device pack, cached by rig parameters (fixed-rig
        sequences compute/compile rectification once)."""
        key = (
            K0.tobytes(), K1.tobytes(), np.asarray(R).tobytes(),
            np.asarray(T).tobytes(), shape,
        )
        hit = cache.get(key)
        if hit is None:
            H, W = shape
            geom = prepare_frame_geometry(
                K0, K1, R, T, (W, H), cam_distance=self.cfg.stereo.cam_distance
            )
            hit = (geom, build_geom_pack(geom, shape))
            cache[key] = hit
        return hit

    def _finalize_stereo_frame(self, wd: Workdir, geom, res, K0, K1, extras) -> np.ndarray:
        """Per-frame finalization: first host sync of this frame's device
        results, mesh/plane export (fused native compact+quantize .xyzC
        writer when available), and the reference's debug artifact set.
        Runs in a writer thread so the dispatch loop never blocks."""
        import time as _time

        from wass_tpu import native

        t0 = _time.time()
        log_lines = []

        # Deferred c2f fallback resolution (writer-thread side of the
        # speculative dispatch): sync the coverage scalars and re-run this
        # frame full-range if the guard trips.
        pipe = extras.get("pipe")
        if pipe is not None and extras.get("c2f") is not None:
            res, extras["c2f"] = pipe.resolve_fallback(
                res, extras["c2f"], *extras["rect"], *extras["dev_imgs"],
                extras["gp"],
            )

        # Projection matrices / camera poses in the cam0 frame, using the
        # same baseline-normalized T as the reconstruction
        # (wass_stereo.cpp:1888-1894).
        P0 = K0 @ np.hstack([np.eye(3), np.zeros((3, 1))])
        P1 = K1 @ np.hstack([geom.R, geom.T.reshape(3, 1)])
        wd.save_projection_matrices(P0, P1)
        wd.save_camera_poses(np.eye(3), np.zeros(3), geom.R, geom.T)
        # Effective-config provenance (save_configuration,
        # wass_stereo.cpp:1858-1859).
        with open(wd.path / "stereo_config.txt", "w") as f:
            for k, v in dataclasses.asdict(self.cfg.stereo).items():
                f.write(f"{k.upper()}={v}\n")

        c2f = extras.get("c2f")
        if c2f is not None:
            log_lines.append(
                f"c2f window coverage: {c2f['coverage']:.4f} "
                f"coherent-offband: {c2f['offband']:.5f} "
                + ("FALLBACK to full-range SGM" if c2f["fallback"] else "windowed")
            )

        n_points = int(res.n_points)  # syncs this frame only
        log_lines.append(f"triangulated+filtered points: {n_points}")

        # MIN_TRIANGULATED_POINTS gate (wass_stereo.cpp:1993-1997): the
        # reference aborts the process; we mark the frame failed (nan
        # plane, empty mesh) and keep the sequence going.
        if n_points < self.cfg.stereo.min_triangulated:
            wd.save_plane(None)
            wd.save_mesh(np.zeros((0, 3)), np.eye(3), np.zeros(3))
            log_lines.append("FRAME FAILED: below MIN_TRIANGULATED_POINTS")
            self._write_stereo_log(wd, log_lines, t0)
            return np.full(4, np.nan)

        plane = np.array(res.plane, np.float64)
        if not bool(res.plane_ok):
            # Degenerate plane fit: record a nan plane so this host's
            # sequence aggregate agrees with the remote allgather gating
            # (plane_ok AND the point gate) and export falls back to the
            # camera frame below.
            plane = np.full(4, np.nan)
        wd.save_plane(plane if np.all(np.isfinite(plane)) else None)
        log_lines.append("plane: " + " ".join(f"{v:.6g}" for v in plane))

        # Export the compressed mesh in the sea-plane frame (the writer
        # contract of PovMesh::save_as_xyz_compressed, PovMesh.cpp:377-460).
        # Quantization + compaction run ON DEVICE (_stage_export): the host
        # fetches exactly the 6n-byte u16 wire payload instead of the 40 MB
        # f32 point grid — the host<->device link, not compute, bounds the
        # e2e rate.
        if np.all(np.isfinite(plane)):
            import jax.numpy as jnp

            from wass_tpu.io.xyzc import decode_delta_payload, save_xyz_quantized
            from wass_tpu.stereo.dense import _stage_export, _stage_export_delta

            _Rp, _Tp, Rinv, Tinv = (
                np.array(a, np.float64) for a in rt_from_plane(jnp.asarray(plane))
            )
            if self.cfg.wire_delta:
                # Delta-coded wire: 3n bytes + rare u16 exceptions; the
                # decode reconstructs the exact u16 values.  The scalar
                # exception count is synced first so degenerate frames
                # (narrow ROI -> mostly exceptions) fall back to the
                # direct 6n fetch instead of paying 3n + 6*exc.
                db_dev, exc_dev, q_dev, nexc_dev, mins_dev, scales_dev = (
                    _stage_export_delta(
                        res.points, res.valid, jnp.asarray(plane, jnp.float32)
                    )
                )
                n_exc = int(nexc_dev)
                # Delta only when it buys a REAL wire saving (>= 25% fewer
                # bytes): real disparity maps carry speckled invalid gaps
                # that make 20-30% of points exceptions, where 3n + 6e
                # barely undercuts 6n and the decode isn't free.
                if 3 * n_points + 6 * n_exc < 0.75 * 6 * n_points:
                    delta_b = np.asarray(db_dev[:n_points])
                    exc_vals = np.asarray(exc_dev[:n_exc])
                    quant = decode_delta_payload(delta_b, exc_vals)
                else:
                    quant = np.asarray(q_dev[:n_points])
            else:
                q_dev, mins_dev, scales_dev = _stage_export(
                    res.points, res.valid, jnp.asarray(plane, jnp.float32)
                )
                quant = np.asarray(q_dev[:n_points])
            save_xyz_quantized(
                wd.path / "mesh_cam.xyzC",
                quant,
                np.asarray(scales_dev), np.asarray(mins_dev),
                Rinv, Tinv,
            )
        else:
            Rinv, Tinv = np.eye(3), np.zeros(3)
            valid = np.array(res.valid)
            pts = np.array(res.points, np.float64)[valid]
            wd.save_mesh(pts, Rinv, Tinv)

        if self.cfg.debug_renders:
            try:
                from wass_tpu.stereo.dense import _jit_disp_u16, _jit_u8
                from wass_tpu.utils.render import (
                    render_coverage, render_disparity, render_stereo,
                )

                # Fetch render sources in reduced precision (u16 fixed-point
                # disparity, u8 images): renders never need f32, and the
                # host<->device link is the production bottleneck.
                disp = np.asarray(_jit_disp_u16(res.disparity)) / 16.0
                render_stereo(
                    wd.path / "stereo_input.jpg", extras["imgs"][0],
                    extras["imgs"][1], vertical=True,
                )
                # Disparity render (:854, :1001).
                render_disparity(wd.path / "disparity_final_scaled.jpg", disp)
                if "rect" in extras:
                    base_rect, match_rect = extras["rect"]
                    base_u8 = np.asarray(_jit_u8(base_rect))
                    match_u8 = np.asarray(_jit_u8(match_rect))
                    # Rectification check stereo.jpg (wass_stereo.cpp:1910-1926).
                    render_stereo(wd.path / "stereo.jpg", base_u8, match_u8)
                    # Coverage over the rectified base (:1017).
                    render_coverage(
                        wd.path / "disparity_coverage.jpg",
                        base_u8, disp, roi=geom.roi,
                    )
                # Component/validity map (graph_components.jpg,
                # PovMesh.cpp:982-984): surviving grid points in white.
                from wass_tpu.utils.render import _save

                _save(
                    wd.path / "graph_components.jpg",
                    np.asarray(res.valid).astype(np.uint8) * 255,
                )
                # Color-coded triangulation failure map
                # (wass_stereo.cpp:1114-1119,1378-1383).
                if res.fail_reasons is not None:
                    from wass_tpu.utils.render import render_failure_map

                    render_failure_map(
                        wd.path / "triangulation_failmap.jpg",
                        np.asarray(res.fail_reasons),
                        base_u8 if "rect" in extras else None,
                    )
            except Exception as e:  # debug imagery must never fail the stage
                log_lines.append(f"debug renders failed: {e}")

        # Optional optical-flow reconstruction (refine_flow,
        # wass_stereo.cpp:1985-1990): a second, flow-based point cloud
        # saved next to the stereo mesh, plus the flow debug renders.
        if self.cfg.flow is not None:
            from wass_tpu.stereo.flow import flow_reconstruct_frame
            from wass_tpu.io.ply import save_ply_points
            from wass_tpu.utils.render import render_flow

            b_img = np.asarray(extras["imgs"][0], np.float32)
            m_img = np.asarray(extras["imgs"][1], np.float32)
            fr = flow_reconstruct_frame(
                res.disparity, b_img, m_img, geom, self.cfg.flow,
                min_disp=float(self.cfg.stereo.min_disp),
                valid_rect=res.valid,
            )
            render_flow(wd.path / "flow_coarse.png", fr.coarse_flow, 200.0)
            render_flow(wd.path / "flow.png", fr.flow, 200.0)
            fpts = fr.points[fr.valid]
            fcol = np.repeat(
                np.asarray(b_img)[fr.valid][:, None], 3, axis=1
            ).astype(np.uint8)
            save_ply_points(wd.path / "mesh_full_flow.ply", fpts, fcol)

        self._write_stereo_log(wd, log_lines, t0)
        return plane

    @staticmethod
    def _write_stereo_log(wd: Workdir, lines, t0) -> None:
        """Per-stage logfile (wass_stereo_log.txt, wass_stereo.cpp:1833)."""
        import time as _time

        with open(wd.path / "wass_stereo_log.txt", "w") as f:
            for ln in lines:
                f.write(f"[INFO] {ln}\n")
            f.write(f"[INFO] finalize wall time: {_time.time()-t0:.3f}s\n")

    def stereo(
        self,
        wds: Optional[Sequence[Workdir]] = None,
        progress_stream=None,
    ) -> List[np.ndarray]:
        """Production dense-stereo loop: native PNG prefetch -> device
        dispatch dispatch_depth frames ahead -> writer-thread finalization
        (the only per-frame host syncs).  With >1 device, frames batch
        through the frame-sharded runner instead."""
        import jax

        wds = list(wds if wds is not None else self.workdirs())
        if self.cfg.stereo.input_smooth_sigma < 0 and wds:
            # AUTO pre-smoothing: estimate the sequence's degradation
            # once from frame 0 (all hosts read the same file on the
            # shared filesystem, so multi-process resolution agrees) and
            # pin the resolved sigma for the whole sequence — one census
            # program, no per-frame recompiles.
            from wass_tpu.prepare.degradation import resolve_smooth_sigma

            self.cfg.stereo = dataclasses.replace(
                self.cfg.stereo,
                input_smooth_sigma=resolve_smooth_sigma(
                    -1.0, wds[0].load_undistorted(0), "dense"
                ),
            )
        if self.cfg.wire_delta is None:
            self.cfg.wire_delta = self._probe_wire_delta()
        if len(jax.devices()) > 1 and len(wds) > 1:
            planes = self._stereo_sharded(wds)
        else:
            planes = self._stereo_pipelined(wds, progress_stream)

        # Multi-process: every host has the full plane list (locals from
        # its finalizers, remotes allgathered), so one writer suffices.
        if jax.process_index() == 0:
            self._write_sequence_outputs(wds, planes)
        return planes

    @staticmethod
    def _wire_delta_decision(link_MBps: float, decode_s_per_pt: float) -> bool:
        """Pure break-even: enable the delta codec iff the host decodes a
        point faster than the link ships the ~1.5 bytes/point the codec
        saves (6n direct vs 3n + 6*~0.25n delta; the measured-typical
        exception fraction).  Both rates are per-point, so the decision
        is frame-size independent."""
        link_s_per_pt = 1.5 / max(link_MBps * 1024 * 1024, 1e-9)
        return bool(link_s_per_pt > decode_s_per_pt)

    @staticmethod
    def _probe_wire_rates() -> tuple:
        """Measure (link download MB/s, host delta-decode s/point)."""
        import time as _time

        import jax
        import jax.numpy as jnp

        from wass_tpu.io.xyzc import decode_delta_payload

        # Download-bandwidth probe, adaptive size: start small so a slow
        # link doesn't spend tens of seconds probing.
        mb = 0.25
        down = 0.0
        for _ in range(2):
            n = int(mb * 1024 * 1024)
            x = jax.block_until_ready(jnp.zeros((n,), jnp.uint8) + 1)
            t0 = _time.time()
            np.asarray(x)
            dt = max(_time.time() - t0, 1e-9)
            down = mb / dt
            if dt > 0.1:
                break
            mb = 4.0  # fast link: re-probe bigger for accuracy
        # Host decode-rate probe (synthetic 500k-point payload, ~25%
        # exceptions like real frames).
        npts = 500_000
        rng = np.random.default_rng(0)
        db = rng.integers(1, 256, (npts, 3)).astype(np.uint8)
        exc = rng.random(npts) < 0.25
        db[exc, 0] = 0
        ev = rng.integers(0, 65535, (int(exc.sum()), 3)).astype(np.uint16)
        t0 = _time.time()
        decode_delta_payload(db, ev)
        decode_s_per_pt = max(_time.time() - t0, 1e-9) / npts
        return down, decode_s_per_pt

    @classmethod
    def _probe_wire_delta(cls) -> bool:
        down, decode_s_per_pt = cls._probe_wire_rates()
        return cls._wire_delta_decision(down, decode_s_per_pt)

    def _stereo_pipelined(self, wds, progress_stream=None) -> List[np.ndarray]:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        import jax
        import jax.numpy as jnp

        from wass_tpu import native
        from wass_tpu.utils.progress import progress

        cfg = self.cfg.stereo
        # Deferred c2f fallback: the dispatch loop never waits on the
        # coverage scalars — writer threads resolve them (and re-run the
        # rare tripped frame full-range) while later frames compute.
        pipe = DenseStereoPipeline(cfg, defer_c2f_fallback=True)
        depth = max(1, self.cfg.dispatch_depth)

        prefetcher = native.Prefetcher(4) if native.available() else None
        tickets = {}

        def submit(i):
            if prefetcher is not None and 0 <= i < len(wds) and i not in tickets:
                tickets[i] = (
                    prefetcher.submit(wds[i].undistorted_path(0)),
                    prefetcher.submit(wds[i].undistorted_path(1)),
                )

        def load_frame(i):
            if prefetcher is not None:
                t0, t1 = tickets.pop(i)
                return prefetcher.take(t0), prefetcher.take(t1)
            return wds[i].load_undistorted(0), wds[i].load_undistorted(1)

        geom_cache: dict = {}
        planes: List[np.ndarray] = [None] * len(wds)
        inflight = deque()
        writers = ThreadPoolExecutor(max_workers=max(1, self.cfg.writer_threads))
        try:
            for i in range(depth + 1):
                submit(i)
            for i, wd in enumerate(wds):
                img0, img1 = load_frame(i)
                submit(i + depth + 1)
                K0 = wd.load_intrinsics(0)
                K1 = wd.load_intrinsics(1)
                R, T = wd.load_extrinsics()
                geom, gp = self._frame_geometry(geom_cache, K0, K1, R, T, img0.shape)
                b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
                H, W = img0.shape
                # uint8 upload (4x less host-to-device traffic than f32), cast on device.
                b = jnp.asarray(np.ascontiguousarray(b_img)).astype(jnp.float32)
                m = jnp.asarray(np.ascontiguousarray(m_img)).astype(jnp.float32)
                base_rect = rectify_on_device(b, geom.H_base, (H, W))
                match_rect = rectify_on_device(m, geom.H_match, (H, W))
                res = pipe(base_rect, match_rect, b, m, gp)

                extras = {
                    "rect": (base_rect, match_rect), "imgs": (b_img, m_img),
                    "c2f": pipe.last_c2f,
                    "pipe": pipe, "dev_imgs": (b, m), "gp": gp,
                }
                fut = writers.submit(
                    self._finalize_stereo_frame, wd, geom, res, K0, K1, extras
                )
                inflight.append((i, fut))
                # Bound the device-buffer backlog; the pop's .result() is
                # the oldest frame's writer, typically already done.
                while len(inflight) > depth:
                    j, f = inflight.popleft()
                    planes[j] = f.result()
                    progress(j + 1, len(wds), stream=progress_stream)
            while inflight:
                j, f = inflight.popleft()
                planes[j] = f.result()
                progress(j + 1, len(wds), stream=progress_stream)
        finally:
            writers.shutdown(wait=True)
            if prefetcher is not None:
                prefetcher.close()
        return planes

    def _stereo_sharded(self, wds) -> List[np.ndarray]:
        """Frame-sharded batches over all devices (data parallelism over
        frames — the wasscli 4-worker thread pool equivalent,
        wasscli.py:277,346).

        Same production standard as _stereo_pipelined: native PNG prefetch
        overlaps the next batch's host loads with device compute, frame
        finalization runs in writer threads, the rectified images come
        back from the device so the full debug artifact set (stereo.jpg,
        coverage) is emitted, and per-frame c2f window diagnostics are
        logged (off-band frames are re-run full-range inside the runner).
        Each frame is rectified inside the sharded step with its own
        geometry.  Ragged tails are padded with the last frame — the pad slots waste
        (n_dev - r) device slots on ONE batch per sequence, which is
        cheaper than compiling a second, smaller SPMD program."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        import jax

        from wass_tpu import native
        from wass_tpu.parallel.mesh import make_frame_mesh
        from wass_tpu.parallel.runner import ShardedDenseRunner, local_frame_indices

        n_dev = len(jax.devices())
        mesh = make_frame_mesh(n_dev)
        runner = ShardedDenseRunner(mesh, self.cfg.stereo)
        multi = jax.process_count() > 1
        # Global batch slots this process owns.  Single-process: all of
        # them.  Multi-process (jax.distributed): each host
        # loads, feeds, and finalizes ONLY its local frames; remote
        # frames' meshes are written by their owning host (the reference's
        # shared-filesystem scaling model, getting_started.html.md:40-47),
        # and only their 4-float planes are allgathered for bookkeeping.
        local_slots = local_frame_indices(mesh)
        local_set = set(local_slots)
        planes: List[np.ndarray] = [None] * len(wds)
        geom_cache: dict = {}
        writers = ThreadPoolExecutor(max_workers=max(1, self.cfg.writer_threads))
        prefetcher = native.Prefetcher(2 * len(local_slots)) if native.available() else None
        tickets: dict = {}

        def submit(i):
            if prefetcher is not None and 0 <= i < len(wds) and i not in tickets:
                tickets[i] = (
                    prefetcher.submit(wds[i].undistorted_path(0)),
                    prefetcher.submit(wds[i].undistorted_path(1)),
                )

        def load(i):
            if prefetcher is not None and i in tickets:
                t0, t1 = tickets.pop(i)
                return prefetcher.take(t0), prefetcher.take(t1)
            return wds[i].load_undistorted(0), wds[i].load_undistorted(1)

        def batch_frame(s, slot, group_n):
            """Workdir index batch slot `slot` maps to (tail slots repeat
            the last real frame — cheaper than a second, smaller SPMD
            program)."""
            return s + min(slot, group_n - 1)

        inflight = deque()
        try:
            for slot in local_slots:
                submit(slot)
                submit(n_dev + slot)
            for s in range(0, len(wds), n_dev):
                group_n = min(n_dev, len(wds) - s)
                # Load each distinct local frame once (padded tail slots
                # reuse the loaded arrays).
                loaded: dict = {}
                for fi in sorted({batch_frame(s, slot, group_n) for slot in local_slots}):
                    img0, img1 = load(fi)
                    submit(fi + n_dev)
                    wd = wds[fi]
                    K0, K1 = wd.load_intrinsics(0), wd.load_intrinsics(1)
                    R, T = wd.load_extrinsics()
                    geom, gp = self._frame_geometry(geom_cache, K0, K1, R, T, img0.shape)
                    b_img, m_img = (img0, img1) if geom.base_is_cam0 else (img1, img0)
                    loaded[fi] = (
                        (b_img.astype(np.float32), m_img.astype(np.float32)),
                        (geom, K0, K1), gp,
                    )
                per_slot = [loaded[batch_frame(s, slot, group_n)] for slot in local_slots]
                imgs = [e[0] for e in per_slot]
                geoms = [e[1] for e in per_slot]
                packs = [e[2] for e in per_slot]

                bb = np.stack([b for b, _ in imgs])
                mb = np.stack([m for _, m in imgs])
                res, rects, info, _mean_plane = runner.run_batch(bb, mb, packs)
                for j, slot in enumerate(local_slots):
                    if slot >= group_n:
                        continue  # padded tail slot, no real frame behind it
                    fi = s + slot
                    wd = wds[fi]
                    # Zero-copy device-resident slice of frame `slot` (the
                    # shard buffer on its owning device): the finalizer
                    # then runs the SAME device-side export as the
                    # pipelined path — _stage_export quantize+compact on
                    # that device, host fetch of only the 6n-byte u16
                    # payload — instead of pulling the full f32 point grid.
                    slice_k = lambda leaf: (
                        None if leaf is None
                        else ShardedDenseRunner._frame_shard_data(leaf, slot)
                    )
                    one = type(res)(*(slice_k(leaf) for leaf in res))
                    geom, K0, K1 = geoms[j]
                    extras = {
                        "imgs": imgs[j],
                        # Device slices: the finalizer fetches u8 casts.
                        "rect": (slice_k(rects[0]), slice_k(rects[1])),
                    }
                    if info["coverage"] is not None:
                        extras["c2f"] = {
                            "coverage": float(info["coverage"][slot]),
                            "offband": float(info["offband"][slot]),
                            "fallback": slot in info["fallback_frames"],
                        }
                    inflight.append((
                        fi,
                        writers.submit(
                            self._finalize_stereo_frame, wd, geom, one, K0, K1, extras
                        ),
                    ))
                if multi:
                    # Remote frames: record their planes (4 floats each)
                    # from the allgathered batch result; their meshes are
                    # written by the owning hosts.
                    from jax.experimental import multihost_utils

                    pg = np.asarray(multihost_utils.process_allgather(res.plane, tiled=True))
                    okg = np.asarray(multihost_utils.process_allgather(res.plane_ok, tiled=True))
                    npg = np.asarray(multihost_utils.process_allgather(res.n_points, tiled=True))
                    for slot in range(group_n):
                        if slot in local_set:
                            continue
                        good = bool(okg[slot]) and int(npg[slot]) >= self.cfg.stereo.min_triangulated
                        planes[s + slot] = (
                            np.array(pg[slot], np.float64) if good else np.full(4, np.nan)
                        )
                while len(inflight) > len(local_slots):
                    j, f = inflight.popleft()
                    planes[j] = f.result()
            while inflight:
                j, f = inflight.popleft()
                planes[j] = f.result()
        finally:
            writers.shutdown(wait=True)
            if prefetcher is not None:
                prefetcher.close()
        return planes

    def _write_sequence_outputs(self, wds, planes) -> None:
        # Aggregate planes (wasscli.py:320-343).
        out = self.outdir / "output"
        out.mkdir(exist_ok=True)
        with open(out / "planes.txt", "w") as f:
            for p in planes:
                if np.all(np.isfinite(p)):
                    f.write(" ".join(f"{v:.18g}" for v in p) + "\n")
        with open(self.outdir / "workspaces.txt", "w") as f:
            for wd in wds:
                f.write(str(wd.path) + "\n")
