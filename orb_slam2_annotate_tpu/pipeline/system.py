"""System facade: host-side orchestration of the SLAM pipeline.

The counterpart of System.cc + the host-side state machine of
Tracking.cc (Track(), Tracking.cc:275-546) + the LocalMapping scheduling
(System.cc:91-102 threads).  All numeric work happens in the jitted
device programs of pipeline/{frame,tracking,local_mapping}.py; this class
only sequences them and keeps a handful of scalars (state, frame counter,
velocity) on host.

Thread model: the reference runs Tracking / LocalMapping / LoopClosing as
three std::threads with queues and mutexes; here device dispatch is
asynchronous, so the host issues tracking for frame k and mapping for the
last keyframe back-to-back and XLA overlaps them.  The map is one
functional value — there is nothing to lock.

Trajectory bookkeeping follows the reference (Tracking.cc:514-544): every
frame stores its pose relative to its reference keyframe, so later map
corrections (BA / loop closure) retroactively improve the full
trajectory when it is recovered at save time (System.cc:327-388).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import enable_compile_cache
from ..geometry import lie
from ..geometry.camera import CameraModel
from ..ops.extractor import ExtractorConfig
from ..ops import matching
from ..solvers import initializer, ba_core, pnp
from ..worldmap import map_state as ms
from ..worldmap import vocabulary as voc
from ..utils.telemetry import Telemetry
from . import local_mapping as lm
from . import tracking as tk
from .frame import Frame, make_frame_mono, make_frame_rgbd, make_frame_stereo
from .loop_closing import LoopCloser, LoopCloserConfig


@dataclasses.dataclass
class SlamConfig:
    sensor: str = "mono"             # mono | stereo | rgbd
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    max_kf: int = 256
    max_mp: int = 16384
    # keyframe policy (NeedNewKeyFrame, Tracking.cc:1075)
    max_frames_between_kf: int = 20
    min_frames_between_kf: int = 1
    kf_ref_ratio: float = 0.8
    min_inliers_track: int = 15      # below -> LOST (Tracking.cc:1019)
    min_inliers_local: int = 30      # TrackLocalMap accept (Tracking.cc:1070)
    th_depth: float = 40.0           # in units of baseline (stereo/rgbd)
    init_min_matches: int = 100
    seed: int = 0
    verbose: bool = False
    # stage toggles (debugging / ablation).
    # fuse (SearchInNeighbors, LocalMapping.cc:511) re-measured r3 after
    # the 512-bit descriptor + triangulation overhaul (multi-seed A/B,
    # 6 seeds, PlaneScene mono): off mean ATE 1.60 cm, on 1.80 cm; RGB-D
    # e2e degrades 0.05 -> 0.11 m.  Root cause is structural, not a
    # tuning gap: on (near-)planar scenes a WRONG match is geometrically
    # self-consistent (same-plane points project/depth-check perfectly),
    # so the reprojection/depth/3D-agreement gates cannot veto what the
    # descriptor confuses — and a wrong fuse permanently corrupts the
    # map where a wrong tracking match only perturbs one frame.  The
    # reference affords always-on fusion via OpenCV-ORB-on-real-texture
    # distinctiveness; ours (margin-trained 512-bit) still confuses
    # repeated texture.  Off by default; the same fuse core runs across
    # loop seams (SearchAndFuse) and session-merge seams, where
    # duplicates are certain and Sim3-verified.
    enable_fuse: bool = False
    # None = follow enable_fuse (fusion needs fresh stats after
    # triangulation); set explicitly to decouple for A/B measurement
    stats_in_triangulate: bool | None = None
    enable_cull: bool = True
    enable_local_ba: bool = True
    enable_loop_closing: bool = True
    enable_relocalization: bool = True
    enable_kf_culling: bool = True
    # free-running path (pipeline/device_loop.py) feature parity toggles
    # — in-program global BA after each live closure (LoopClosing.cc:756)
    # and the auto-reset-after-early-loss branch (Tracking.cc:496-504)
    free_live_gba: bool = True
    # tier bound for in-program GBA: full-map BA cost grows ~K*N edges x
    # P points, and at K=640 one closure's live GBA measured minutes
    # (r5 long run, block fps 6.3 -> 0.3) — beyond this keyframe tier
    # the per-frame program skips the branch and finish() runs the
    # reference's deferred refinement instead (RunGlobalBundleAdjustment
    # runs asynchronously in the reference too; tracking never waits on
    # it, LoopClosing.cc:678,756)
    free_live_gba_max_kf: int = 256
    free_auto_reset: bool = True
    # shard the map-point axis of the WHOLE live pipeline over the device
    # mesh (SURVEY §2.3 final row): every per-keyframe program (tracking
    # projection/matching over [P], the fused keyframe chain's
    # triangulation + local BA, loop closing) then runs SPMD with XLA
    # inserting the collectives.  The mesh spans every device JAX sees
    # (one device: one shard); global BA after a closure shards over it.
    shard_points: bool = False
    # pipelined dispatch: keep up to this many frames in flight before
    # resolving their (prefetched) stats, so the host never blocks on the
    # device link inside the hot loop.  Keyframe/LOST decisions then lag
    # by up to async_depth frames — the functional analog of the
    # reference's tracking-vs-LocalMapping thread decoupling
    # (System.cc:91, LocalMapping queue).  0 = fully synchronous.
    async_depth: int = 0

    @property
    def extractor(self) -> ExtractorConfig:
        return ExtractorConfig(
            n_features=self.n_features, n_levels=self.n_levels, scale=self.scale
        )


@dataclasses.dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    ref_kf_slot: int
    # pose of this frame relative to its reference keyframe: Tcr = Tcw Twr
    R_cr: np.ndarray
    t_cr: np.ndarray
    lost: bool


class System:
    """End-to-end SLAM engine (mono fully wired; stereo/rgbd via depth)."""

    def __init__(self, cam: CameraModel, config: SlamConfig | None = None):
        self.cam = cam
        self.cfg = config or SlamConfig()
        self.map = ms.empty_map(self.cfg.max_kf, self.cfg.max_mp,
                                self.cfg.n_features)
        enable_compile_cache()
        self._mesh = None
        if self.cfg.shard_points:
            from ..parallel.mesh import map_mesh

            self._mesh = map_mesh()
            self.map = self._place_map(self.map)
        self.state = "NO_IMAGES"     # NO_IMAGES -> NOT_INITIALIZED -> OK | LOST
        self.frame_id = -1
        self.records: list[FrameRecord] = []
        self._rng = np.random.RandomState(self.cfg.seed)
        # host mirrors of tiny map facts, so the hot loop never blocks on a
        # device->host read
        self._kf_valid_host = np.zeros(self.cfg.max_kf, bool)
        self._pending_det = None     # (slot, LoopDetectOut) awaiting resolve
        self._pending_cull = None    # CullInfo awaiting (prefetched) resolve
        self._inflight: list[dict] = []   # pipelined frames awaiting stats

        # tracker state
        self.last_frame: Optional[Frame] = None
        self.last_obs = None         # [N] mp ids of last frame
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.vel = None              # (R, t) of Tcw_cur @ Tcw_last^-1
        self.ref_kf = 0              # slot of reference keyframe
        self.last_kf_frame = -999
        self.ref_tracked = 0         # inliers when ref KF was made
        self._last_n_local = 0
        # mono init
        self._init_frame: Optional[Frame] = None
        # loop closing / relocalization
        self.telemetry = Telemetry()
        self.loop_closer = LoopCloser(
            cam, self.cfg.max_kf,
            LoopCloserConfig(fix_scale=self.cfg.sensor != "mono"),
            seed=self.cfg.seed + 1, mesh=self._mesh,
        ) if self.cfg.enable_loop_closing or self.cfg.enable_relocalization else None
        self.frames_since_reloc = 0

    # ------------------------------------------------------------------
    # public API (System.h:62-123 equivalents)
    # ------------------------------------------------------------------

    def warmup(self):
        """Compile AND execute every device program the steady-state
        pipeline can reach, then restore the (empty) map state.

        The reference never JIT-compiles, so it has no frame-37 stall; a
        compiled-graph runtime must precompile to honor the real-time
        budget.  This executes each program on throwaway inputs rather
        than just tracing it, so first-execution costs (executable load,
        autotuning) are paid here too.  Call once before the frame loop.
        """
        snap = (self.map, self.state, self.frame_id, self.last_frame,
                self.last_obs, self.R, self.t, self.vel, self.ref_kf,
                self.last_kf_frame, self._kf_valid_host.copy())
        db_snap = self.loop_closer.db if self.loop_closer is not None else None
        try:
            cam, cfg = self.cam, self.cfg
            img = np.zeros((int(cam.height), int(cam.width)), np.uint8)
            has_depth = cfg.sensor in ("stereo", "rgbd")
            if cfg.sensor == "stereo":
                frame = make_frame_stereo(self._upload(img), self._upload(img),
                                          cam, cfg.extractor)
            elif cfg.sensor == "rgbd":
                dep = jnp.asarray(np.ones((int(cam.height), int(cam.width)),
                                          np.float32))
                frame = make_frame_rgbd(self._upload(img), dep, cam,
                                        cfg.extractor)
            else:
                frame = make_frame_mono(self._upload(img), cam, cfg.extractor)
            obs0 = jnp.full((frame.xy.shape[0],), -1, jnp.int32)
            # fused tracking step (the exact dispatch _track/_track_async use)
            step = tk.track_frame(
                self.cam, self.map, frame, frame, obs0,
                self.R, self.t, jnp.eye(3), jnp.zeros(3),
                jnp.asarray(False), jnp.asarray(self.ref_kf, jnp.int32),
            )
            np.asarray(step.stats)
            # fused keyframe chain, exactly as _run_keyframe_chain
            # dispatches it — BOTH cull variants (the live system switches
            # from do_kf_cull=False to True once the map holds >8 KFs)
            m = self.map
            for do_cull in ((False, True) if cfg.enable_kf_culling
                            else (False,)):
                baseline = (float(cam.bf) / float(cam.fx)
                            if has_depth else 0.0)
                m, _, cull_info = lm.keyframe_chain(
                    self.map, cam, frame, step.R, step.t, step.obs, 0, 0.0,
                    cfg.th_depth * baseline,
                    has_depth=has_depth,
                    do_cull_recent=cfg.enable_cull,
                    stats_in_triangulate=(cfg.enable_fuse if cfg.stats_in_triangulate is None else cfg.stats_in_triangulate),
                    do_fuse=cfg.enable_fuse,
                    do_local_ba=cfg.enable_local_ba,
                    do_kf_cull=do_cull,
                )
                np.asarray(cull_info.ok)
            if self.loop_closer is not None:
                det = self.loop_closer.dispatch_detection(m, 0)
                np.asarray(det.ok)
                # batched relocalization program
                cand = tk.relocalize_candidates(
                    cam, m, frame, self.loop_closer.vocab,
                    self.loop_closer.db.bows, jax.random.PRNGKey(0))
                np.asarray(cand.best_slot)
                res2 = tk.track_local_map(cam, m, frame,
                                          cand.R, cand.t, cand.obs)
                np.asarray(res2.n_inliers)
            jax.block_until_ready(m.kf_R)
        finally:
            (self.map, self.state, self.frame_id, self.last_frame,
             self.last_obs, self.R, self.t, self.vel, self.ref_kf,
             self.last_kf_frame, self._kf_valid_host) = snap
            if self.loop_closer is not None:
                self.loop_closer.db = db_snap

    @staticmethod
    def _upload(image) -> jnp.ndarray:
        """Ship uint8 images as uint8 (4x less host->device traffic; the
        f32 cast happens on device inside the extraction program)."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = img.astype(np.float32)
        return jnp.asarray(img)

    def track_mono(self, image: np.ndarray, timestamp: float):
        """image: [H,W] grayscale float32/uint8.  Returns 4x4 Tcw or None."""
        with self.telemetry.stage("frontend/extract"):
            frame = make_frame_mono(self._upload(image), self.cam,
                                    self.cfg.extractor)
        return self._track(frame, timestamp)

    def track_rgbd(self, image, depth, timestamp: float):
        dep = jnp.asarray(np.asarray(depth, np.float32))
        frame = make_frame_rgbd(self._upload(image), dep, self.cam,
                                self.cfg.extractor)
        return self._track(frame, timestamp, has_depth=True)

    def track_stereo(self, image_l, image_r, timestamp: float):
        frame = make_frame_stereo(self._upload(image_l), self._upload(image_r),
                                  self.cam, self.cfg.extractor)
        return self._track(frame, timestamp, has_depth=True)

    def activate_localization_mode(self):
        """Track against the frozen map without mapping
        (System::ActivateLocalizationMode, System.cc:229-247)."""
        self._localization_only = True

    def deactivate_localization_mode(self):
        self._localization_only = False

    def change_calibration(self, cam: CameraModel):
        """Runtime recalibration (Tracking::ChangeCalibration,
        Tracking.cc:1683)."""
        self.cam = cam

    def reset(self):
        self.__init__(self.cam, self.cfg)

    def save_map(self, path: str):
        """Persist the map (reference System.h:115 SaveMap TODO)."""
        self.flush()
        from ..io import checkpoint

        checkpoint.save_map(path, self.map, extra={
            "frame_id": self.frame_id,
            "ref_kf": int(self.ref_kf),
        })

    def load_map(self, path: str):
        """Restore a map; tracking resumes in relocalization mode."""
        from ..io import checkpoint

        self.map, extra = checkpoint.load_map(path)
        self.map = self._place_map(self.map)
        self.state = "LOST"          # must relocalize into the loaded map
        self.vel = None
        self.ref_kf = int(extra.get("ref_kf", 0))
        self._kf_valid_host = np.asarray(self.map.kf_valid).copy()
        if self.loop_closer is not None:
            # rebuild the BoW database from keyframe descriptors — one
            # vmapped program over all K slots (shared with FreeRunner
            # .load_map, pipeline/policy.py)
            from . import policy

            lc = self.loop_closer
            lc.db = voc.KeyFrameDatabase(
                policy.keyframe_bows(lc.vocab, self.map))

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _track(self, frame: Frame, timestamp: float, has_depth: bool = False):
        self.frame_id += 1
        self._cur_ts = timestamp
        if self.state in ("NO_IMAGES", "NOT_INITIALIZED"):
            if has_depth:
                ok = self._initialize_depth(frame, timestamp)
            else:
                ok = self._initialize_mono(frame, timestamp)
            if not ok:
                self._record(lost=True)
                return None
            self.state = "OK"
            self._record()
            return self._pose44()

        # ---- track: ONE fused device dispatch for the whole state machine
        has_vel = self.vel is not None
        vel_R, vel_t = self.vel if has_vel else (jnp.eye(3), jnp.zeros(3))
        if self.last_frame is None or self.last_obs is None:
            # e.g. first frame after load_map: no previous frame exists;
            # the motion-model branch is disabled but still traced
            self.last_frame = frame
            self.last_obs = jnp.full((frame.xy.shape[0],), -1, jnp.int32)
            has_vel = False
        if self.cfg.async_depth > 0:
            return self._track_async(frame, timestamp, has_depth,
                                     has_vel, vel_R, vel_t)
        with self.telemetry.stage("tracking/step"):
            step = tk.track_frame(
                self.cam, self.map, frame, self.last_frame, self.last_obs,
                self.R, self.t, vel_R, vel_t,
                jnp.asarray(has_vel), jnp.asarray(self.ref_kf, jnp.int32),
            )
            step.stats.copy_to_host_async()
            step.poses.copy_to_host_async()
            stats = np.asarray(step.stats)
            poses = np.asarray(step.poses)
        n_pre, n_local = int(stats[0]), int(stats[1])
        if self.cfg.verbose:
            print(f"  [track] f{self.frame_id}: pre={n_pre} local={n_local} "
                  f"local_kf={int(stats[2])} ref_tracked={self.ref_tracked}")

        if n_pre < self.cfg.min_inliers_track or n_local < self.cfg.min_inliers_local:
            if not (n_pre < self.cfg.min_inliers_track and self._try_relocalize(frame)):
                self.state = "LOST"
                self.vel = None
                self._record(lost=True)
                self._maybe_auto_reset()
                return None
            # relocalized: re-run the fused step from the recovered pose
            step = tk.track_frame(
                self.cam, self.map, frame, self.last_frame, self.last_obs,
                self.R, self.t, jnp.eye(3), jnp.zeros(3),
                jnp.asarray(False), jnp.asarray(self.ref_kf, jnp.int32),
            )
            stats = np.asarray(step.stats)
            poses = np.asarray(step.poses)
            n_local = int(stats[1])
            if n_local < self.cfg.min_inliers_local:
                self.state = "LOST"
                self.vel = None
                self._record(lost=True)
                return None

        self.map = self.map._replace(
            mp_visible=step.mp_visible, mp_found=step.mp_found
        )
        self._last_n_local = n_local
        self._peak_n_local = max(getattr(self, "_peak_n_local", 0), n_local)
        self.state = "OK"  # recovered (reference re-enters OK after reloc)

        # host copies come from the prefetched bundle — no device reads
        R_np, t_np = tk.unpack_pose(poses[0])
        self.vel = (jnp.asarray(poses[1][:9].reshape(3, 3)),
                    jnp.asarray(poses[1][9:12]))
        self.R, self.t = step.R, step.t
        self._pose_np = (R_np, t_np)
        self._rel_np = tk.unpack_pose(poses[2])
        self.last_frame = frame
        self.last_obs = step.obs

        # ---- keyframe policy
        if getattr(self, "_localization_only", False):
            self._record()
            return self._pose44()
        if self._need_keyframe(n_local):
            self._create_keyframe(frame, timestamp, step.obs, has_depth)
        self._record()
        return self._pose44()

    # ---- pipelined tracking (async_depth > 0) --------------------------

    def _track_async(self, frame: Frame, timestamp: float, has_depth: bool,
                     has_vel: bool, vel_R, vel_t):
        """Dispatch this frame's fused tracking step and resolve the
        oldest in-flight frame's (already prefetched) stats.  The host
        never blocks on the device inside this method in steady state;
        keyframe/LOST policy lags by async_depth frames, mirroring the
        reference's tracking-vs-mapping thread decoupling."""
        if self.state == "LOST":
            self.last_frame = frame
            self.last_obs = jnp.full((frame.xy.shape[0],), -1, jnp.int32)
            if not self._try_relocalize(frame):
                self._record(lost=True)
                return None
            # recovered: record this frame relative to the reloc keyframe
            Rr = np.asarray(self.map.kf_R[self.ref_kf])
            tr = np.asarray(self.map.kf_t[self.ref_kf])
            R_np, t_np = np.asarray(self.R), np.asarray(self.t)
            Rcr = R_np @ Rr.T
            self._rel_np = (Rcr, t_np - Rcr @ tr)
            self._pose_np = (R_np, t_np)
            self._record()
            return self._pose44()

        step = tk.track_frame(
            self.cam, self.map, frame, self.last_frame, self.last_obs,
            self.R, self.t, vel_R, vel_t,
            jnp.asarray(has_vel), jnp.asarray(self.ref_kf, jnp.int32),
        )
        step.stats.copy_to_host_async()
        step.poses.copy_to_host_async()
        # fold found/visible counters so the next dispatch sees them, and
        # advance the device-side tracker state — zero host reads
        self.map = self.map._replace(mp_visible=step.mp_visible,
                                     mp_found=step.mp_found)
        self.R, self.t = step.R, step.t
        self.vel = (step.poses[1, :9].reshape(3, 3), step.poses[1, 9:12])
        self.last_frame = frame
        self.last_obs = step.obs
        self._inflight.append(dict(
            frame_id=self.frame_id, ts=timestamp, ref_kf=self.ref_kf,
            frame=frame, step=step, has_depth=has_depth,
        ))
        # resolve every frame whose stats have already landed on the host
        # (free — the pipeline stays full), and block only when the
        # pipeline exceeds async_depth.  Effective decision lag therefore
        # adapts to the real device latency instead of always being
        # async_depth: keyframes stay fresh when the device keeps up.
        while self._inflight:
            ready = self._inflight[0]["step"].stats.is_ready()
            if not ready and len(self._inflight) <= self.cfg.async_depth:
                break
            if not self._resolve_oldest():
                break
        # the definitive pose is still in flight; hand back the device
        # array (np.asarray by the caller would sync — their choice)
        return (jnp.eye(4).at[:3, :3].set(step.R).at[:3, 3].set(step.t))

    def _lost_record(self, e: dict):
        self.records.append(FrameRecord(
            e["frame_id"], e["ts"], e["ref_kf"],
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), True))

    def _resolve_oldest(self) -> bool:
        """Resolve the oldest in-flight frame.  Returns False if tracking
        was lost (pipeline drained)."""
        e = self._inflight.pop(0)
        stats = np.asarray(e["step"].stats)
        n_pre, n_local = int(stats[0]), int(stats[1])
        if self.cfg.verbose:
            print(f"  [track] f{e['frame_id']}: pre={n_pre} local={n_local} "
                  f"(lag {self.frame_id - e['frame_id']})")
        if n_pre < self.cfg.min_inliers_track or \
                n_local < self.cfg.min_inliers_local:
            # every later in-flight frame chained off this bad pose
            self._lost_record(e)
            for e2 in self._inflight:
                self._lost_record(e2)
            self._inflight.clear()
            self.state = "LOST"
            self.vel = None
            if self._try_relocalize(self.last_frame):
                self.state = "OK"
            else:
                self._maybe_auto_reset()
            return False

        poses = np.asarray(e["step"].poses)
        self._last_n_local = n_local
        self._peak_n_local = max(getattr(self, "_peak_n_local", 0), n_local)
        Rcr, tcr = tk.unpack_pose(poses[2])
        rec = FrameRecord(e["frame_id"], e["ts"], e["ref_kf"],
                          np.asarray(Rcr, np.float32).copy(),
                          np.asarray(tcr, np.float32).copy(), False)
        if not getattr(self, "_localization_only", False) and \
                self._need_keyframe(n_local, e["frame_id"]):
            slot = self._create_keyframe_async(e)
            # this frame IS the new reference keyframe
            rec = FrameRecord(e["frame_id"], e["ts"], slot,
                              np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32), False)
        self.records.append(rec)
        return True

    def _place_map(self, m):
        """Re-apply the mesh sharding (after construction, growth or
        load; jitted updates preserve it on their own)."""
        if self._mesh is None:
            return m
        from ..parallel.mesh import shard_map_state

        return shard_map_state(m, self._mesh)

    def _ensure_capacity(self):
        """Grow the map's (K, P) capacity tiers before inserting a
        keyframe (SURVEY §7; replaces the silent slot-0 overwrite the
        round-1 free_kf_slot had when the map filled up).

        Keyframe tier: doubled when every slot is live (host mirror, no
        device read).  Map-point tier: a host-side upper bound on live
        points (each keyframe adds at most 2N new points) triggers ONE
        device read of the true count; the tier doubles only if the true
        headroom is short.  Growth re-jits the pipeline at the new shapes.
        """
        if self._kf_valid_host.all():
            new_K = 2 * self.map.K
            self.map = self._place_map(ms.grow_map(self.map, new_K=new_K))
            self._kf_valid_host = np.concatenate([
                self._kf_valid_host,
                np.zeros(new_K - len(self._kf_valid_host), bool),
            ])
            if self.loop_closer is not None:
                self.loop_closer.grow_db(new_K)
            if self.cfg.verbose:
                print(f"  [map] keyframe capacity -> {new_K}")
        n = self.map.N
        self._mp_upper = getattr(self, "_mp_upper", 0) + 2 * n
        if self._mp_upper + 2 * n > self.map.P:
            self._mp_upper = self.n_mappoints  # one device read, rare
            if self._mp_upper + 2 * n > self.map.P:
                new_P = 2 * self.map.P
                self.map = self._place_map(ms.grow_map(self.map, new_P=new_P))
                if self.cfg.verbose:
                    print(f"  [map] map-point capacity -> {new_P}")

    def _create_keyframe_async(self, e: dict) -> int:
        """Keyframe chain for a lagged frame: all device work is enqueued;
        the two read-back bundles (keyframe culling, loop detection) are
        deferred to the NEXT keyframe so they are long prefetched."""
        self._ensure_capacity()
        # resolve deferred bookkeeping from the previous keyframe first
        if self._pending_cull is not None:
            self._apply_cull_info(self._pending_cull)
            self._pending_cull = None
        if self._pending_det is not None:
            det_slot, det = self._pending_det
            self._pending_det = None
            if self.cfg.enable_loop_closing:
                self.map, closed = self.loop_closer.resolve_detection(
                    self.map, det_slot, det)
                if closed and self.cfg.verbose:
                    print(f"  [loop] closed at kf slot {det_slot}")
        if self.loop_closer is not None:
            self.map = self.loop_closer.maybe_fold_gba(self.map)

        slot = int(np.argmin(self._kf_valid_host))
        self.map, cull_info = self._run_keyframe_chain(
            e["frame"], e["step"].R, e["step"].t, e["step"].obs,
            e["frame_id"], e["ts"], e["has_depth"])
        self._kf_valid_host[slot] = True
        if cull_info is not None:
            for a in (cull_info.slots, cull_info.ok, cull_info.new_ref,
                      cull_info.R_rel, cull_info.t_rel):
                a.copy_to_host_async()
            self._pending_cull = cull_info
        if self.loop_closer is not None:
            self._pending_det = (
                slot, self.loop_closer.dispatch_detection(self.map, slot))
        self.ref_kf = slot
        self.last_kf_frame = e["frame_id"]
        self.ref_tracked = self._last_n_local
        self._peak_n_local = 0
        return slot

    def _run_keyframe_chain(self, frame, R, t, obs, frame_id, ts,
                            has_depth: bool):
        """Dispatch the whole mapping chain as ONE fused device program
        (lm.keyframe_chain); mp stats (distinctive descriptor / normal /
        scale band) are recomputed once at its end over the covisible
        window's points.  Returns (map, CullInfo | None)."""
        baseline = float(self.cam.bf) / float(self.cam.fx) if has_depth else 0.0
        # +1: the keyframe being inserted by this chain isn't marked in
        # _kf_valid_host yet — count it so cull onset matches the old
        # inline code which checked after marking the slot valid
        do_kf_cull = self.cfg.enable_kf_culling and self.n_keyframes + 1 > 8
        m, _, cull_info = lm.keyframe_chain(
            self.map, self.cam, frame, R, t, obs, frame_id, ts,
            self.cfg.th_depth * baseline,
            has_depth=has_depth,
            do_cull_recent=self.cfg.enable_cull,
            stats_in_triangulate=(self.cfg.enable_fuse if self.cfg.stats_in_triangulate is None else self.cfg.stats_in_triangulate),
            do_fuse=self.cfg.enable_fuse,
            do_local_ba=self.cfg.enable_local_ba,
            do_kf_cull=do_kf_cull,
        )
        return m, (cull_info if do_kf_cull else None)

    def flush(self):
        """Drain all in-flight pipelined work (async mode).  Call before
        reading trajectories / map state at the end of a sequence."""
        while self._inflight:
            if not self._resolve_oldest():
                break
        if self._pending_cull is not None:
            self._apply_cull_info(self._pending_cull)
            self._pending_cull = None
        if self._pending_det is not None:
            det_slot, det = self._pending_det
            self._pending_det = None
            if self.cfg.enable_loop_closing:
                self.map, _ = self.loop_closer.resolve_detection(
                    self.map, det_slot, det)
        if self.loop_closer is not None:
            self.map = self.loop_closer.maybe_fold_gba(self.map, force=True)

    def _maybe_auto_reset(self):
        """Tracking lost right after initialization (map has <= 5
        keyframes): the bootstrap map is unsalvageable — reset the whole
        system so the next frames re-initialize (Tracking.cc:496-504,
        System::Reset via mpSystem->Reset())."""
        if self.state == "LOST" and 0 < self.n_keyframes <= 5:
            if self.cfg.verbose:
                print("  [reset] lost soon after init; resetting map")
            self.reset()

    def _need_keyframe(self, n_tracked: int, frame_id: int | None = None) -> bool:
        """Keyframe decision — the SAME shared predicate the free-running
        device loop evaluates on device scalars (pipeline/policy.py,
        NeedNewKeyFrame, Tracking.cc:1075), here on host ints."""
        from . import policy

        since = (self.frame_id if frame_id is None else frame_id) \
            - self.last_kf_frame
        return bool(policy.need_new_keyframe(
            since, n_tracked, getattr(self, "_peak_n_local", 0),
            min_frames=self.cfg.min_frames_between_kf,
            max_frames=self.cfg.max_frames_between_kf,
            ref_ratio=self.cfg.kf_ref_ratio,
            min_track=self.cfg.min_inliers_track))

    def _create_keyframe(self, frame, timestamp, obs, has_depth):
        self._ensure_capacity()
        self._tele_kf = self.telemetry.stage("mapping/keyframe")
        self._tele_kf.__enter__()
        # the slot argmin is mirrored on host so the whole mapping chain
        # below dispatches with zero device->host reads
        slot = int(np.argmin(self._kf_valid_host))
        self.map, cull_info = self._run_keyframe_chain(
            frame, self.R, self.t, obs, self.frame_id, timestamp, has_depth)
        self._kf_valid_host[slot] = True
        if cull_info is not None:
            for a in (cull_info.slots, cull_info.ok, cull_info.new_ref,
                      cull_info.R_rel, cull_info.t_rel):
                a.copy_to_host_async()
        if self.loop_closer is not None:
            # dispatch loop detection (also writes the BoW row the
            # relocalizer needs); resolve immediately — the bundle is
            # small and prefetched
            det = self.loop_closer.dispatch_detection(self.map, slot)
            if self.cfg.enable_loop_closing:
                self.map, closed = self.loop_closer.resolve_detection(
                    self.map, slot, det)
                if closed and self.cfg.verbose:
                    print(f"  [loop] closed at kf slot {slot}")
            self.map = self.loop_closer.maybe_fold_gba(self.map)
        if cull_info is not None:
            self._apply_cull_info(cull_info)
        # adopt possibly-updated pose of the new keyframe
        self.R = self.map.kf_R[slot]
        self.t = self.map.kf_t[slot]
        # the tracked frame IS this keyframe: adopt its observation row,
        # which reflects all fusion remaps / culls / BA outlier removal
        # (stale map-point ids would starve the next motion-model search)
        self.last_obs = self.map.kf_obs[slot]
        self.ref_kf = slot
        self._rel_np = None          # this frame IS the reference keyframe
        self.last_kf_frame = self.frame_id
        self.ref_tracked = self._last_n_local
        self._peak_n_local = 0  # restart the decay baseline
        self._tele_kf.__exit__(None, None, None)

    def _apply_cull_info(self, info):
        """Fold a prefetched CullInfo bundle into the host mirrors and
        re-reference affected frame records."""
        ok = np.asarray(info.ok)
        if not ok.any():
            return
        slots = np.asarray(info.slots)[ok]
        self._kf_valid_host[slots] = False
        self._reparent_records(slots, np.asarray(info.new_ref)[ok],
                               np.asarray(info.R_rel)[ok],
                               np.asarray(info.t_rel)[ok])

    # ---- mono initialization (MonocularInitialization, Tracking.cc:603) --

    def _initialize_mono(self, frame: Frame, timestamp: float) -> bool:
        n_feat = int(jnp.sum(frame.valid))
        if self._init_frame is None:
            if n_feat >= self.cfg.init_min_matches:
                self._init_frame = frame
                self._init_ts = timestamp
                self._init_fid = self.frame_id
            self.state = "NOT_INITIALIZED"
            return False
        if n_feat < self.cfg.init_min_matches:
            self._init_frame = None
            return False

        f0 = self._init_frame
        res = matching.search_for_initialization(f0, frame, window=100.0)
        n_matches = int(res.count)
        if n_matches < self.cfg.init_min_matches:
            self._init_frame = None  # restart (Tracking.cc:632-638)
            return False

        idx = res.idx
        x2 = frame.xy[jnp.clip(idx, 0)]
        key = jax.random.PRNGKey(self._rng.randint(2**31))
        # min_parallax 2.5 deg: consecutive-frame pairs with tiny baseline
        # triangulate a noisy bootstrap map that poisons the whole run;
        # waiting ~2 frames of the orbit-scale motion costs little and
        # halves final ATE on the synthetic benchmark (the reference's
        # 1 deg gate assumes TUM-scale handheld baselines, Initializer.cc)
        init = initializer.initialize_two_view(
            key, f0.xy, x2, res.matched, 200, 1.0, self.cam.K,
            min_parallax_deg=2.5,
        )
        if not bool(init.success):
            return False

        # ---- shared bootstrap-map builder (pipeline/policy.py): scale
        # normalization to median depth 1 (Tracking.cc:779-800), KF0+KF1
        # insertion, map points, stats, initial two-view BA — the SAME
        # traced function the free-running device loop inlines
        from . import policy

        self.map, obs1 = policy.build_mono_init_map(
            self.map, self.cam, f0, frame, init, idx,
            self._init_fid, self._init_ts, self.frame_id, timestamp)

        self.R = self.map.kf_R[1]
        self.t = self.map.kf_t[1]
        self.last_frame = frame
        self.last_obs = obs1
        self.vel = None
        self.ref_kf = 1
        self._kf_valid_host[:2] = True
        self._pose_np = None
        self._rel_np = None
        self.last_kf_frame = self.frame_id
        self.ref_tracked = int(init.n_good)
        self._init_frame = None
        return True

    # ---- stereo/RGB-D initialization (StereoInitialization, :549) -------

    def _initialize_depth(self, frame: Frame, timestamp: float) -> bool:
        n_depth = int(jnp.sum(frame.valid & (frame.depth > 0)))
        # reference gate is 500 of ~1000+ features (Tracking.cc:551);
        # scale with the configured budget so 512-feature configs can
        # initialize (stereo matching yields depth on ~60-80% of features)
        if n_depth < min(500, self.cfg.n_features // 2):
            return False
        from . import policy

        baseline = float(self.cam.bf) / float(self.cam.fx)
        self.map, slot = policy.build_depth_init_map(
            self.map, self.cam, frame, self.frame_id, timestamp,
            self.cfg.th_depth * baseline)
        slot = int(slot)
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.last_frame = frame
        self.last_obs = self.map.kf_obs[slot]
        self.vel = None
        self.ref_kf = slot
        self._kf_valid_host[slot] = True
        self._pose_np = None
        self._rel_np = None
        self.last_kf_frame = self.frame_id
        self.ref_tracked = int(jnp.sum(self.map.kf_obs[slot] >= 0))
        return True

    def _reparent_records(self, culled, new_refs, R_rels, t_rels):
        """Re-express FrameRecords whose reference keyframe was culled
        relative to a surviving keyframe (the reference walks the spanning
        tree at save time instead, System.cc:366-371; we rewrite eagerly
        using the relative transforms the cull kernel computed while the
        culled pose was still known)."""
        by_slot = {int(c): (int(nr), R_rels[i], t_rels[i])
                   for i, (c, nr) in enumerate(zip(culled, new_refs))}
        for rec in self.records:
            if rec.lost or rec.ref_kf_slot not in by_slot:
                continue
            new_ref, R_rel, t_rel = by_slot[rec.ref_kf_slot]
            # Tcr' = Tcr * Trel   (Trel = T_old * T_new^-1)
            rec.t_cr = rec.R_cr @ t_rel + rec.t_cr
            rec.R_cr = rec.R_cr @ R_rel
            rec.ref_kf_slot = new_ref

    # ---- relocalization (Tracking::Relocalization, Tracking.cc:1462) --

    def _try_relocalize(self, frame: Frame) -> bool:
        """One fused device program over ALL BoW candidates (descriptor
        match -> batched DLT-PnP RANSAC -> LM polish, with covisibility-
        accumulated candidate scoring), then one track_local_map
        refinement of the winner.  Two host syncs total, vs 3+ per
        candidate in the round-1 sequential loop (weak item 6).
        Success >= 50 inliers like the reference (Tracking.cc:1617)."""
        if self.loop_closer is None or not self.cfg.enable_relocalization:
            return False
        if self.n_keyframes < 2:
            return False
        lc = self.loop_closer
        cand = tk.relocalize_candidates(
            self.cam, self.map, frame, lc.vocab, lc.db.bows,
            jax.random.PRNGKey(self.frame_id),
        )
        slot = int(cand.best_slot)  # one sync; bundle is tiny
        if slot < 0:
            return False
        # refine via local map tracking from the winning PnP pose
        res2 = tk.track_local_map(self.cam, self.map, frame,
                                  cand.R, cand.t, cand.obs)
        if int(res2.n_inliers) < 50:
            return False
        self.R, self.t = res2.R, res2.t
        self.last_frame = frame
        self.last_obs = res2.obs
        self.vel = None
        self.ref_kf = slot
        self.state = "OK"
        self.frames_since_reloc = 0
        if self.cfg.verbose:
            print(f"  [reloc] recovered against kf slot {slot} "
                  f"({int(res2.n_inliers)} inliers)")
        return True

    # ---- bookkeeping --------------------------------------------------

    def _pose44(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        if getattr(self, "_pose_np", None) is not None:
            T[:3, :3], T[:3, 3] = self._pose_np
        else:
            T[:3, :3] = np.asarray(self.R)
            T[:3, 3] = np.asarray(self.t)
        return T

    def _record(self, lost: bool = False):
        ts = getattr(self, "_cur_ts", 0.0)
        if lost or self.state not in ("OK",):
            self.records.append(
                FrameRecord(self.frame_id, ts, self.ref_kf,
                            np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32), True)
            )
            return
        # Tcr = Tcw * Twr, computed on device inside the fused tracking
        # step (or identity right after this frame became the reference
        # keyframe / the map was initialized from it)
        if getattr(self, "_rel_np", None) is not None:
            Rcr, tcr = self._rel_np
        else:
            Rcr = np.eye(3, dtype=np.float32)
            tcr = np.zeros(3, np.float32)
        self.records.append(
            FrameRecord(self.frame_id, ts, self.ref_kf,
                        np.asarray(Rcr, np.float32).copy(),
                        np.asarray(tcr, np.float32).copy(), False)
        )

    def frame_trajectory(self):
        """Recover the full-frame trajectory through current KF poses
        (System::SaveTrajectoryTUM semantics, System.cc:327-388).

        Returns list of (frame_id, 4x4 Tcw or None).
        """
        self.flush()
        out = []
        kf_R = np.asarray(self.map.kf_R)
        kf_t = np.asarray(self.map.kf_t)
        for rec in self.records:
            if rec.lost:
                out.append((rec.frame_id, None))
                continue
            Rr, tr = kf_R[rec.ref_kf_slot], kf_t[rec.ref_kf_slot]
            R = rec.R_cr @ Rr
            t = rec.R_cr @ tr + rec.t_cr
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = t
            out.append((rec.frame_id, T))
        return out

    def keyframe_trajectory(self):
        """(slot, 4x4 Tcw) for all valid keyframes, by frame id order."""
        self.flush()
        v = np.asarray(self.map.kf_valid)
        fids = np.asarray(self.map.kf_frame_id)
        kf_R = np.asarray(self.map.kf_R)
        kf_t = np.asarray(self.map.kf_t)
        out = []
        for s in np.argsort(fids):
            if not v[s]:
                continue
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = kf_R[s]
            T[:3, 3] = kf_t[s]
            out.append((int(fids[s]), T))
        return out

    @property
    def observation_overflow(self):
        """(n_points_over_MAX_OBS, n_observations_dropped) — MAX_OBS
        truncation telemetry (ms.observation_overflow)."""
        n, d = ms.observation_overflow(self.map)
        return int(n), int(d)

    @property
    def n_keyframes(self) -> int:
        return int(self._kf_valid_host.sum())

    @property
    def n_mappoints(self) -> int:
        return int(jnp.sum(self.map.mp_valid))
