"""Per-frame tracking: the device-side hot path of Tracking.cc.

Each stage of the reference's Track() state machine
(Tracking.cc:275-546) is one jitted program over the functional MapState:

* track_with_motion_model   (Tracking.cc:958 + ORBmatcher.cc:1484)
* track_reference_keyframe  (Tracking.cc:833 + SearchByBoW)
* track_local_map           (Tracking.cc:1025-1073, SearchLocalPoints)

State that the reference spreads across Frame/MapPoint pointers is carried
as a per-frame observation vector obs[N] = map-point id per feature (-1 =
none) — the functional analog of Frame::mvpMapPoints.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from ..geometry.camera import CameraModel, in_image, project
from ..ops import matching
from ..ops.hamming import MAX_DIST
from ..solvers import pose_opt
from ..worldmap import map_state as ms
from ..worldmap.map_state import MapState
from .frame import Frame

SCALE = 1.2

# Hot-path ablation knobs (tools/ab_mono_fps.py measures their fps/ATE
# cost on the real chip; defaults reflect the r5 measurement).  Module-
# level so every call site — sync System and FreeRunner — sees one
# configuration; env-var override enables subprocess A/B without
# plumbing through every step-program signature.
WIDEN_RETRY = os.environ.get("ORBTPU_WIDEN_RETRY", "1") != "0"
MAX_LOCAL_PTS = int(os.environ.get("ORBTPU_MAX_LOCAL_PTS", "4096"))
GAMMA_VEL = float(os.environ.get("ORBTPU_GAMMA_VEL", "1.0"))


def _inv_sigma2(octave):
    return 1.0 / (SCALE ** (2.0 * octave.astype(jnp.float32)))


def _pose_obs_from_obs(m: MapState, frame: Frame, obs: jnp.ndarray) -> pose_opt.PoseObs:
    """Build the unary observation set for pose optimization from obs[N]."""
    ids = jnp.clip(obs, 0)
    valid = (obs >= 0) & frame.valid & m.mp_valid[ids]
    return pose_opt.PoseObs(
        xw=m.mp_pos[ids],
        uv=frame.xy,
        ur=frame.ur,
        inv_sigma2=_inv_sigma2(frame.octave),
        valid=valid,
    )


@jax.jit
def track_with_motion_model(cam: CameraModel, m: MapState, frame: Frame,
                            last_frame: Frame, last_obs: jnp.ndarray,
                            R_pred, t_pred, th: float = 15.0):
    """Project last frame's map points at the predicted pose and match.

    Returns (R, t, obs [N], n_inliers).
    """
    ids = jnp.clip(last_obs, 0)
    has = (last_obs >= 0) & m.mp_valid[ids]
    xw = m.mp_pos[ids]
    xc = xw @ R_pred.T + t_pred
    uv = project(cam, xc)
    pvalid = has & (xc[:, 2] > 0.05) & in_image(cam, uv)

    radius = th * (SCALE ** last_frame.octave.astype(jnp.float32))
    res = matching.search_frame_to_frame(
        frame, last_frame, uv, pvalid, last_frame.octave, radius
    )
    # matched: last feature i -> current feature res.idx[i]; carry mp id over
    N = frame.xy.shape[0]
    obs = jnp.full((N,), -1, jnp.int32)
    src = jnp.where(res.matched & has, last_obs, -1)
    obs = obs.at[jnp.clip(res.idx, 0)].max(jnp.where(res.matched, src, -1))

    pobs = _pose_obs_from_obs(m, frame, obs)
    R, t, inlier, n = pose_opt.optimize_pose(cam, R_pred, t_pred, pobs)
    obs = jnp.where(inlier | ~pobs.valid, obs, -1)
    return R, t, obs, n


@jax.jit
def track_reference_keyframe(cam: CameraModel, m: MapState, frame: Frame,
                             kf_id, R0, t0):
    """Brute-force descriptor match against a reference keyframe's
    map-point features, then pose optimization from the last pose.

    The reference restricts comparisons to shared BoW nodes purely for CPU
    speed (SearchByBoW, ORBmatcher.cc:185); dense [N,N] Hamming is one
    fused pass on an accelerator, so we keep only the ratio/rotation
    tests.
    """
    kf_desc = m.kf_desc[kf_id]
    kf_obs = m.kf_obs[kf_id]
    kf_has = (kf_obs >= 0) & m.kf_feat_valid[kf_id] & m.mp_valid[jnp.clip(kf_obs, 0)]

    cand = kf_has[:, None] & frame.valid[None, :]
    res = matching.match_masked(kf_desc, frame.desc, cand,
                                max_dist=matching.TH_LOW, ratio=0.7)
    ang2 = frame.angle[jnp.clip(res.idx, 0)]
    keep = matching.rotation_consistency(m.kf_angle[kf_id], ang2, res.matched)

    N = frame.xy.shape[0]
    obs = jnp.full((N,), -1, jnp.int32)
    src = jnp.where(keep, kf_obs, -1)
    obs = obs.at[jnp.clip(res.idx, 0)].max(jnp.where(keep, src, -1))

    pobs = _pose_obs_from_obs(m, frame, obs)
    R, t, inlier, n = pose_opt.optimize_pose(cam, R0, t0, pobs)
    obs = jnp.where(inlier | ~pobs.valid, obs, -1)
    return R, t, obs, n


class LocalMapTrack(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    obs: jnp.ndarray
    n_inliers: jnp.ndarray
    n_local_kf: jnp.ndarray
    mp_visible: jnp.ndarray  # updated counters to fold back into MapState
    mp_found: jnp.ndarray


@partial(jax.jit, static_argnums=(6, 7))
def track_local_map(cam: CameraModel, m: MapState, frame: Frame, R, t, obs,
                    max_local_kf: int = 32,
                    max_local_pts: int = MAX_LOCAL_PTS,
                    th: float = 1.0) -> LocalMapTrack:
    """SearchLocalPoints + final pose refinement (Tracking.cc:1025-1073).

    The local keyframe set (K1 of UpdateLocalKeyFrames, Tracking.cc:1339)
    is computed by a vote matmul; the local point set is every point those
    keyframes observe; frustum + viewing-cone + scale-band gating follows
    Frame::isInFrustum (Frame.cc:297-353).
    """
    P = m.P
    N = frame.xy.shape[0]
    max_local_kf = min(max_local_kf, m.K)    # small-capacity maps
    max_local_pts = min(max_local_pts, P)

    # --- local keyframes by shared-point votes.  votes[k] =
    # |obs_k ∩ cur_pts| as a gather of the current-point mask at every
    # observation — the [K,P] observation-matrix build this replaces is
    # a K*N-update scatter (O(K*P) at grown tiers) and ran EVERY frame
    # here
    cur_pts = jnp.zeros((P,), bool).at[jnp.clip(obs, 0)].max(obs >= 0)
    all_ok = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    votes = jnp.sum(cur_pts[jnp.clip(m.kf_obs, 0)] & all_ok,
                    axis=1).astype(jnp.float32)           # [K]
    votes = jnp.where(m.kf_valid, votes, -1.0)
    top_votes, local_kf = jax.lax.top_k(votes, max_local_kf)
    kf_sel = top_votes > 0  # [LK]
    n_local_kf = jnp.sum(kf_sel)

    # --- local points = union of those keyframes' observations
    local_mask = ms.point_mask_rows(m, local_kf, kf_sel)  # [P]
    local_mask &= m.mp_valid & ~cur_pts

    # --- frustum / viewing cone / scale band (isInFrustum)
    xc = m.mp_pos @ R.T + t
    uv = project(cam, xc)
    cam_center = -R.T @ t
    dvec = m.mp_pos - cam_center
    dist = jnp.linalg.norm(dvec, axis=-1)
    view_cos = jnp.sum(dvec * m.mp_normal, axis=-1) / jnp.maximum(dist, 1e-9)
    in_frustum = (
        (xc[:, 2] > 0.05)
        & in_image(cam, uv)
        & (dist >= m.mp_min_dist)
        & (dist <= m.mp_max_dist)
        & (view_cos > 0.5)
    )
    cand_mask = local_mask & in_frustum

    # predicted octave from distance (MapPoint::PredictScale, MapPoint.cc:418)
    # — clipped to the pyramid's ACTUAL top level like the reference's
    # mnScaleLevels-1 (frames may run fewer than 8 levels; a prediction
    # beyond the top level would fail every octave gate)
    top_oct = jnp.max(jnp.where(frame.valid, frame.octave, 0))
    ratio = jnp.maximum(m.mp_max_dist / jnp.maximum(dist, 1e-9), 1.0)
    pred_oct = jnp.clip(
        jnp.ceil(jnp.log(ratio) / jnp.log(SCALE)).astype(jnp.int32), 0, top_oct
    )

    # --- take up to max_local_pts candidates.  When the local set
    # exceeds the cap, keep the most RECENTLY CREATED points first: a
    # plain 0/1 top_k keeps the lowest slot indices, i.e. the oldest
    # points — which silently truncates exactly the fresh-scenery points
    # the tracker needs as the view moves into newly mapped territory
    # (measured r4 long-run: periodic tracking collapse at the fresh
    # edge of large 1024-feature maps; the reference has no cap — it
    # searches every local-KF point, Tracking.cc:1246).  first_kf >= 0,
    # so candidates score >= 2.0 and invalids 0.0; integers up to 2^24
    # are exact in f32, so the recency ordering never quantizes away
    # (a 1e-9 epsilon would vanish below the ulp at 1.0).
    cand_score = jnp.where(
        cand_mask, m.mp_first_kf.astype(jnp.float32) + 2.0, 0.0)
    _, cand = jax.lax.top_k(cand_score, max_local_pts)
    cvalid = cand_mask[cand]

    # search radius: RadiusByViewingCos (ORBmatcher.cc:105) x scale
    r0 = jnp.where(view_cos[cand] > 0.998, 2.5, 4.0)
    radius = th * r0 * (SCALE ** pred_oct[cand].astype(jnp.float32))

    res = matching.search_map_points(
        m.mp_desc[cand], cvalid, uv[cand], pred_oct[cand], radius, frame,
        ratio=0.8, max_dist=matching.TH_HIGH,
    )
    # fold new matches into obs (never overwrite existing associations)
    tgt = jnp.clip(res.idx, 0)
    newmp = jnp.where(res.matched, cand, -1)
    prop = jnp.full((N,), -1, jnp.int32).at[tgt].max(newmp)
    obs = jnp.where(obs >= 0, obs, jnp.where(frame.valid, prop, -1))

    # --- final pose optimization over all associations
    pobs = _pose_obs_from_obs(m, frame, obs)
    R2, t2, inlier, n = pose_opt.optimize_pose(cam, R, t, pobs)
    obs = jnp.where(inlier | ~pobs.valid, obs, -1)

    # --- visible/found statistics (Tracking.cc:1246-1295 semantics)
    mp_visible = m.mp_visible.at[cand].add(cvalid.astype(jnp.int32))
    ids = jnp.clip(obs, 0)
    found_mask = (obs >= 0) & inlier
    mp_found = m.mp_found.at[ids].add(found_mask.astype(jnp.int32))
    return LocalMapTrack(R2, t2, obs, n, n_local_kf, mp_visible, mp_found)


class RelocCandidates(NamedTuple):
    """One fused relocalization dispatch over all candidates.

    best_slot/best_score are scalars (host reads once); R/t/obs belong to
    the best candidate and seed the track_local_map refinement.
    """
    best_slot: jnp.ndarray   # i32 (-1 = no candidate)
    best_score: jnp.ndarray  # i32 PnP inliers of the winner
    R: jnp.ndarray           # [3,3]
    t: jnp.ndarray           # [3]
    obs: jnp.ndarray         # [N] map-point ids from the winning match


@jax.jit
def relocalize_candidates(cam: CameraModel, m: MapState, frame: Frame,
                          vocab, db_bows, key) -> RelocCandidates:
    """Relocalization, device-batched (Tracking::Relocalization,
    Tracking.cc:1462 + KeyFrameDatabase::DetectRelocalizationCandidates,
    KeyFrameDatabase.cc:228).

    The reference loops candidates on the CPU — BoW match, EPnP RANSAC,
    pose optimization each — until one sticks.  Here ALL candidates run
    as one vmapped program (descriptor match -> DLT-PnP RANSAC -> robust
    LM polish), candidate scoring includes the covisibility-accumulated
    BoW score the round-1 path skipped, and the host reads back one small
    bundle.  The winner is then refined by ONE track_local_map call.
    """
    from ..solvers import pnp
    from ..worldmap import vocabulary as voc
    from ..worldmap import map_state as ms

    N = frame.xy.shape[0]
    bow = voc.bow_vector(vocab, frame.desc, frame.valid)
    covis = ms.covisibility(m)
    slots, ok = voc.detect_relocalization_candidates(
        voc.KeyFrameDatabase(db_bows), bow, m.kf_valid, covis
    )

    def per_cand(i):
        slot = slots[i]
        obs_kf = m.kf_obs[slot]
        has = (obs_kf >= 0) & m.kf_feat_valid[slot] & m.mp_valid[
            jnp.clip(obs_kf, 0)]
        cand_mask = has[:, None] & frame.valid[None, :]
        res = matching.match_masked(
            m.kf_desc[slot], frame.desc, cand_mask,
            max_dist=matching.TH_LOW, ratio=0.75,
        )
        obs = jnp.full((N,), -1, jnp.int32).at[jnp.clip(res.idx, 0)].max(
            jnp.where(res.matched, jnp.where(has, obs_kf, -1), -1)
        )
        pvalid = (obs >= 0) & frame.valid
        n_matches = jnp.sum(pvalid)
        r = pnp.pnp_ransac(
            jax.random.fold_in(key, i), cam,
            m.mp_pos[jnp.clip(obs, 0)], frame.xy, pvalid, min_inliers=15,
        )
        score = jnp.where(ok[i] & r.success & (n_matches >= 15),
                          r.n_inliers, -1).astype(jnp.int32)
        return score, r.R, r.t, obs

    scores, Rs, ts, obss = jax.vmap(per_cand)(jnp.arange(slots.shape[0]))
    best = jnp.argmax(scores)
    found = scores[best] > 0
    return RelocCandidates(
        best_slot=jnp.where(found, slots[best], -1).astype(jnp.int32),
        best_score=scores[best],
        R=Rs[best], t=ts[best], obs=obss[best],
    )


class TrackStep(NamedTuple):
    """Everything the host needs from one frame, in one dispatch.

    `stats` packs the small integers ([n_pre, n_local, n_local_kf]) and
    `poses` the small floats (R, t, vel, Tcr) so the host prefetches two
    tiny arrays instead of nine: each read is a device sync."""
    R: jnp.ndarray
    t: jnp.ndarray
    obs: jnp.ndarray
    mp_visible: jnp.ndarray
    mp_found: jnp.ndarray
    stats: jnp.ndarray   # [3] i32: n_pre, n_local, n_local_kf
    poses: jnp.ndarray   # [4,12] f32 rows: Tcw, T_vel, Tcr, (Rpred|unused)


def _pack_pose(R, t):
    return jnp.concatenate([R.reshape(9), t.reshape(3)])


def unpack_pose(row):
    """Host-side: row [12] -> (R [3,3], t [3])."""
    return row[:9].reshape(3, 3), row[9:12]


@jax.jit
def track_frame(cam: CameraModel, m: MapState, frame: Frame,
                last_frame: Frame, last_obs: jnp.ndarray,
                R_last, t_last, vel_R, vel_t, has_vel, ref_kf) -> TrackStep:
    """The full per-frame tracking state machine as ONE device program
    (Track(), Tracking.cc:275-546, minus host-side keyframe policy):

      motion-model track (if a velocity exists)
        -> reference-keyframe track when it fails (< 20 inliers)
        -> local-map track + final pose optimization
        -> motion-model velocity + pose relative to the reference KF

    The reference interleaves these stages with shared-pointer checks;
    here the fallback is a lax.cond so the host never has to read back an
    intermediate inlier count mid-frame.
    """
    N = frame.xy.shape[0]

    def with_motion(_):
        R_pred, t_pred = lie.se3_compose(vel_R, vel_t, R_last, t_last)
        out = track_with_motion_model(
            cam, m, frame, last_frame, last_obs, R_pred, t_pred)

        # widen-retry (Tracking.cc:985-988): when the 15-px window finds
        # too few matches — fast rotation leaves the constant-velocity
        # prediction several px off, and px-constant windows cover half
        # the physical angle at 2x the focal length — search again at
        # 2x the radius before falling back to reference-KF tracking
        if not WIDEN_RETRY:
            return out

        def retry(_):
            return track_with_motion_model(
                cam, m, frame, last_frame, last_obs, R_pred, t_pred,
                th=30.0)

        return jax.lax.cond(out[3] < 20, retry, lambda _: out, None)

    def without(_):
        return (R_last, t_last, jnp.full((N,), -1, jnp.int32),
                jnp.asarray(-1, jnp.int32))

    R1, t1, obs1, n1 = jax.lax.cond(has_vel, with_motion, without, None)

    def ref_track(_):
        return track_reference_keyframe(cam, m, frame, ref_kf, R_last, t_last)

    def keep(_):
        return R1, t1, obs1, n1

    R2, t2, obs2, n2 = jax.lax.cond(n1 < 20, ref_track, keep, None)

    res = track_local_map(cam, m, frame, R2, t2, obs2)

    # velocity = Tcw_cur * Tcw_last^-1 (Tracking.cc:446-454), optionally
    # damped in the tangent space (GAMMA_VEL < 1).  Raw extrapolation can
    # close a positive-feedback loop on weakly-observable pose modes
    # (near-planar scenes): prediction carries the full error increment,
    # matching/optimization confirm it (zero innovation along the weak
    # mode), and the error grows ~1.6x/frame.  Round 4 moved to 1.0
    # because the widen-retry recovers the matches damping existed to
    # protect (the r2 divergence predates both retry and the recency
    # local-point cap); tools/ab_mono_fps.py A/Bs both.
    Ri, ti = lie.se3_inverse(R_last, t_last)
    vR_raw, vt_raw = lie.se3_compose(res.R, res.t, Ri, ti)
    vR, vt = lie.se3_exp(GAMMA_VEL * lie.se3_log(vR_raw, vt_raw))
    # pose relative to reference keyframe: Tcr = Tcw * Twr (Tracking.cc:514)
    Rr, tr = m.kf_R[ref_kf], m.kf_t[ref_kf]
    Rri, tri = lie.se3_inverse(Rr, tr)
    Rcr, tcr = lie.se3_compose(res.R, res.t, Rri, tri)

    stats = jnp.stack([n2.astype(jnp.int32), res.n_inliers.astype(jnp.int32),
                       res.n_local_kf.astype(jnp.int32)])
    poses = jnp.stack([
        _pack_pose(res.R, res.t),
        _pack_pose(vR, vt),
        _pack_pose(Rcr, tcr),
        jnp.zeros((12,)),
    ])
    return TrackStep(res.R, res.t, res.obs, res.mp_visible, res.mp_found,
                     stats, poses)
