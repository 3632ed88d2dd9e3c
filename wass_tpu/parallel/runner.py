"""Frame-sharded sequence runner: batches of stereo frames across a mesh.

The multi-device/multi-host production path.  Design (SPMD): one frame
per device per step, expressed with jax.shard_map over a ("frame",) mesh —
inside the shard the local batch axis is squeezed away and the
*unbatched* per-frame pipeline runs, so the SGM kernel executes exactly
as in the single-device path with no custom-call partitioning or vmap
rules involved.  XLA inserts the only collective of the step (the
sequence mean-plane reduction) from a plain jnp.nanmean over the sharded
plane array.

This replaces the reference's "N worker processes over a shared
filesystem" scaling model (/root/reference/cli/wasscli/wasscli.py:48,277,
346; docs: getting_started.html.md:40-47).

On several hosts, call jax.distributed.initialize() first; the same code
then spans hosts, with each host feeding its local shard of frames:
_put switches to jax.make_array_from_process_local_data when
jax.process_count() > 1, so each process passes ONLY the frames its
addressable devices own (local_frame_indices gives the assignment).
Exercised for real by the 2-process gloo-backed CPU test
(tests/test_multiprocess.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wass_tpu.stereo.dense import (
    DenseStereoConfig,
    DenseFrameResult,
    _c2f_active,
    _jit_c2f_coarse,
    _jit_c2f_windows,
    c2f_should_fallback,
    disparity_postprocess,
    _stage_disparity,
    _stage_points,
    _stage_plane,
)
from wass_tpu.ops.sampling import warp_homography


def _frame_pipeline(bi, mi, gp, cfg: DenseStereoConfig, rectified: bool):
    """Unbatched per-frame dense pipeline (runs inside one shard).

    Returns (DenseFrameResult, (base_rect, match_rect), (coverage,
    offband)): the c2f window diagnostics are 1/0 when c2f is inactive,
    so the host can apply the full-range fallback per batch."""
    if rectified:
        br, mr = bi, mi
    else:
        br = warp_homography(bi, gp["H_base"], bi.shape)
        mr = warp_homography(mi, gp["H_match"], mi.shape)

    if _c2f_active(cfg, br.shape):
        from wass_tpu.stereo.c2f import sgm_disparity_windowed

        disp_c = _jit_c2f_coarse.__wrapped__(br, mr, cfg)
        wstart, cov, offb = _jit_c2f_windows.__wrapped__(disp_c, cfg)
        disp = sgm_disparity_windowed(
            br, mr, wstart, cfg.c2f_window, cfg.p1, cfg.p2, cfg.directions,
            cfg.census_win, cfg.uniqueness_ratio, cfg.input_smooth_sigma,
        )
        disp = disparity_postprocess(disp, cfg)
    else:
        disp = _stage_disparity.__wrapped__(br, mr, cfg)
        cov = jnp.float32(1.0)
        offb = jnp.float32(0.0)

    pts, valid, reasons = _stage_points.__wrapped__(disp, gp, br, mr, cfg)
    plane, ok, valid = _stage_plane.__wrapped__(pts, valid, cfg)
    res = DenseFrameResult(pts, valid, plane, ok, disp, jnp.sum(valid), reasons)
    return res, (br, mr), (cov, offb)


def build_sharded_step(mesh: Mesh, cfg: DenseStereoConfig, rectified: bool):
    """One jitted SPMD step: (F, H, W) x2 + stacked geom packs, all sharded
    P("frame") with F == mesh devices, -> (DenseFrameResult batch, rect
    image batch, (coverage, offband) batches, mean plane)."""

    spec = P("frame")

    def local_step(base_b, match_b, gp_b):
        bi, mi = base_b[0], match_b[0]
        gp = jax.tree.map(lambda x: x[0], gp_b)
        res, rects, diag = _frame_pipeline(bi, mi, gp, cfg, rectified)
        add_f = lambda t: jax.tree.map(lambda x: x[None], t)
        return add_f(res), add_f(rects), add_f(diag)

    # check_vma off: the SGM scan carries are initialized inside the shard
    # (unvarying consts) and become frame-varying through the scan, which
    # the varying-manual-axes checker rejects; the computation itself is
    # embarrassingly frame-parallel.
    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )

    @jax.jit
    def step(base_b, match_b, gp_b):
        res, rects, diag = sharded(base_b, match_b, gp_b)
        # The sequence reduction: XLA lowers this nanmean over the sharded
        # frame axis to the cross-device collective (the wasscli
        # "aggregate planes over NFS" equivalent, wasscli.py:320-343).
        mean_plane = jnp.nanmean(res.plane, axis=0)
        return res, rects, diag, mean_plane

    return step


def stack_geom_packs(packs: Sequence[dict]) -> dict:
    """Stack per-frame geom_pack dicts (build_geom_pack) along a new frame
    axis for the sharded step."""
    keys = packs[0].keys()
    return {k: jnp.stack([p[k] for p in packs]) for k in keys}


def local_frame_indices(mesh: Mesh) -> List[int]:
    """Global frame slots owned by THIS process under P("frame") sharding:
    the positions of this process's addressable devices in the mesh's
    device order.  On a single host this is range(n_devices)."""
    pid = jax.process_index()
    return [
        k for k, d in enumerate(mesh.devices.flat) if d.process_index == pid
    ]


def replace_frame_shard(tree, k: int, update_tree):
    """Replace global frame slot k of a P("frame")-sharded result pytree
    (one frame per device) with a single-frame update, by shard-buffer
    surgery: rebuild each leaf with jax.make_array_from_single_device_arrays,
    swapping only device k's buffer.  No collective, no recompilation, and
    it works identically in multi-process mode (only the owner's
    addressable shards are touched)."""

    def repl(x, y):
        arrays = []
        for s in x.addressable_shards:
            if s.index[0].start == k:
                arrays.append(jax.device_put(jnp.asarray(y)[None], s.device))
            else:
                arrays.append(s.data)
        return jax.make_array_from_single_device_arrays(x.shape, x.sharding, arrays)

    return jax.tree.map(repl, tree, update_tree)


class ShardedDenseRunner:
    """Runs batches of frame pairs sharded across the device mesh, one
    frame per device per step.

    Each frame carries its own geometry (geom_pack entries are batched);
    fixed-rig sequences simply feed identical packs.  When every frame of
    a batch shares one rectification homography, pass rectified inputs
    (warped once per frame before sharding) and rectified=True.

    c2f safety: the step returns per-frame window coverage/offband
    diagnostics; ONLY the frames that trip c2f_should_fallback are re-run,
    each through a jitted single-frame full-range program (cfg with c2f
    disabled), and spliced back into the batch by shard-buffer surgery —
    the other frames' results are reused, never recomputed (the sharded
    equivalent of DenseStereoPipeline's per-frame fallback, without the
    whole-batch 2x re-run cliff)."""

    def __init__(self, mesh: Mesh, cfg: DenseStereoConfig):
        self.mesh = mesh
        # An unresolved AUTO (negative) input_smooth_sigma flows through:
        # the census level maps the sentinel to the clean-input baseline
        # (0.8) identically in every entry point; cli/pipeline.stereo
        # resolves it against the actual input before building a runner.
        self.cfg = cfg
        self.cfg_full = dataclasses.replace(cfg, c2f_window=0)
        self.fsh = NamedSharding(mesh, P("frame"))
        self._steps: dict = {}
        # Diagnostics: how many single-frame full-range re-runs this runner
        # has executed (tests assert fallback granularity through this).
        self.n_fallback_reruns = 0

    @property
    def batch_size(self) -> int:
        return self.mesh.shape["frame"]

    def _step_fn(self, cfg, rectified: bool):
        key = (cfg, rectified)
        if key not in self._steps:
            self._steps[key] = build_sharded_step(self.mesh, cfg, rectified)
        return self._steps[key]

    def _single_full_fn(self, rectified: bool):
        """Jitted SINGLE-frame full-range pipeline for fallback re-runs."""
        key = ("single_full", rectified)
        if key not in self._steps:
            cfg = self.cfg_full

            @jax.jit
            def single(bi, mi, gp):
                res, rects, _diag = _frame_pipeline(bi, mi, gp, cfg, rectified)
                return res, rects

            self._steps[key] = single
        return self._steps[key]

    @staticmethod
    def _frame_shard_data(x, k: int):
        """Device-resident data of global frame slot k (owner process)."""
        for s in x.addressable_shards:
            if s.index[0].start == k:
                return s.data[0]
        raise KeyError(f"frame {k} is not addressable from this process")

    def _put(self, base_img, match_img, geom_packs):
        """Upload one batch.  Single-process: plain device_put against the
        global NamedSharding.  Multi-process (jax.distributed):
        device_put with non-addressable devices is invalid, so each process
        feeds ONLY its local frames via
        jax.make_array_from_process_local_data — base_img/match_img/
        geom_packs then carry len(local_frame_indices(mesh)) frames and the
        global batch axis is n_processes times longer."""
        gp_local = jax.tree.map(np.asarray, stack_geom_packs(geom_packs))
        if jax.process_count() > 1:
            n_local = int(np.asarray(base_img).shape[0])
            n_global = n_local * jax.process_count()

            def put(x):
                x = np.asarray(x)
                return jax.make_array_from_process_local_data(
                    self.fsh, x, (n_global,) + x.shape[1:]
                )

            return put(base_img), put(match_img), jax.tree.map(put, gp_local)
        put = lambda x: jax.device_put(np.asarray(x), self.fsh)
        return put(base_img), put(match_img), jax.device_put(gp_local, self.fsh)

    def run_batch(
        self,
        base_img,
        match_img,
        geom_packs: Sequence[dict],
        rectified: bool = False,
    ):
        """base_img/match_img: (F, H, W) base/match-role images (undistorted,
        or rectified when rectified=True); geom_packs: one build_geom_pack
        dict per frame.  Returns (DenseFrameResult batch, (base_rect,
        match_rect) batch, c2f diagnostics dict, mean plane)."""
        multi = jax.process_count() > 1
        n_local = len(local_frame_indices(self.mesh)) if multi else self.batch_size
        assert len(geom_packs) == n_local and base_img.shape[0] == n_local, (
            "the SPMD step runs one frame per device: pass exactly "
            f"{n_local} frames per batch from this process"
        )
        bb, mb, gp = self._put(base_img, match_img, geom_packs)
        res, rects, diag, mean_plane = self._step_fn(self.cfg, rectified)(bb, mb, gp)

        if multi:
            from jax.experimental import multihost_utils

            fetch = lambda x: np.asarray(
                multihost_utils.process_allgather(x, tiled=True)
            )
        else:
            fetch = np.asarray

        info = {"coverage": None, "offband": None, "fallback_frames": []}
        cov = fetch(diag[0])
        offb = fetch(diag[1])
        if _c2f_active(self.cfg, base_img.shape[1:]):
            info["coverage"], info["offband"] = cov, offb
        bad = self._select_fallback(cov, offb, base_img.shape[1:])
        if bad:
            # Re-run ONLY the tripped frames, each through the jitted
            # single-frame full-range program on its owning device, and
            # splice the replacements into the batch buffers.  In
            # multi-process mode every process handles just its local
            # tripped frames; `bad` itself is globally consistent.
            info["fallback_frames"] = bad
            local = set(local_frame_indices(self.mesh))
            single = self._single_full_fn(rectified)
            for k in bad:
                if k not in local:
                    continue
                gp_k = jax.tree.map(lambda x: self._frame_shard_data(x, k), gp)
                res_k, rects_k = single(
                    self._frame_shard_data(bb, k),
                    self._frame_shard_data(mb, k),
                    gp_k,
                )
                self.n_fallback_reruns += 1
                res = replace_frame_shard(res, k, res_k)
                rects = replace_frame_shard(rects, k, rects_k)
            # Host-side mean over the (tiny) per-frame planes: the
            # spliced result needs no further device program.
            planes = fetch(res.plane)
            with np.errstate(invalid="ignore"):
                mean_plane = jnp.asarray(np.nanmean(planes, axis=0))
        return res, rects, info, mean_plane

    def _select_fallback(self, cov, offb, shape) -> List[int]:
        """Global batch slots whose c2f windows missed (full-range re-run
        needed).  Separate from run_batch so tests can drive the fallback
        mechanics on meshes where c2f itself is inactive."""
        if not _c2f_active(self.cfg, shape):
            return []
        return [
            k for k in range(len(cov))
            if c2f_should_fallback(float(cov[k]), float(offb[k]), self.cfg)
        ]


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None):
    """jax.distributed bootstrap for several hosts; no-op on a single host."""
    if coordinator is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num_processes, process_id=process_id
    )
    return True
