"""Local mapping: keyframe processing, triangulation, fusion, local BA.

The device-side counterpart of LocalMapping.cc.  Each stage of the
reference's Run() loop (LocalMapping.cc:47-118) is a pure jitted function
MapState -> MapState; the host System calls them after each keyframe
insertion instead of running a separate thread (JAX dispatch is already
asynchronous, so tracking's next frame overlaps with mapping work on
device).

Stages and their reference counterparts:
* insert_keyframe_from_frame  — ProcessNewKeyFrame (LocalMapping.cc:143)
* cull_recent_mappoints       — MapPointCulling (LocalMapping.cc:207)
* create_new_mappoints        — CreateNewMapPoints (LocalMapping.cc:253)
* fuse_neighbors              — SearchInNeighbors (LocalMapping.cc:511)
* local_bundle_adjustment     — Optimizer::LocalBundleAdjustment
                                (Optimizer.cc:483)
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
from ..ops.hamming import hamming_pairwise
from ..geometry.twoview import triangulate_dlt
from ..solvers import ba_core
from ..worldmap import map_state as ms
from .frame import Frame

SCALE = 1.2
N_LEVELS = 8

# LBA schedule (robust iters, post-outlier-mask iters): each iteration
# linearizes once and tries a 3-value damping ladder (ba_core).  The
# schedule sets most of the keyframe chain's cost.
_LBA = os.environ.get("ORBTPU_LBA_ITERS", "4,6").split(",")
LBA_ITERS_ROBUST = int(_LBA[0])
LBA_ITERS_FINAL = int(_LBA[1])


def _inv_sigma2(octave):
    return 1.0 / (SCALE ** (2.0 * octave.astype(jnp.float32)))


@partial(jax.jit, static_argnames=("update_stats",))
def insert_keyframe_from_frame(m: ms.MapState, frame: Frame, R, t,
                               obs, frame_id, timestamp,
                               update_stats: bool = True) -> tuple[ms.MapState, jnp.ndarray]:
    """Insert the tracked frame as a keyframe.  Returns (map, slot).

    update_stats=False skips the (non-cheap) distinctive-descriptor /
    normal recompute; the caller must run ms.update_mappoint_stats once
    at the end of its keyframe chain instead."""
    slot = ms.free_kf_slot(m)
    m = ms.insert_keyframe(
        m, slot, R, t, frame_id, timestamp,
        frame.xy, frame.ur, frame.depth, frame.octave, frame.angle,
        frame.desc, frame.valid, jnp.where(frame.valid, obs, -1),
    )
    if update_stats:
        m = ms.update_mappoint_stats(m)
    return m, slot


@partial(jax.jit, static_argnames=("update_stats",))
def create_depth_mappoints(m: ms.MapState, cam: CameraModel, slot,
                           max_depth, update_stats: bool = True) -> ms.MapState:
    """Stereo/RGB-D: spawn map points for close features lacking one
    (StereoInitialization Tracking.cc:549 + CreateNewKeyFrame
    Tracking.cc:1164-1238: create points with depth < ThDepth*baseline)."""
    N = m.N
    depth = m.kf_depth[slot]
    need = (
        m.kf_feat_valid[slot]
        & (m.kf_obs[slot] < 0)
        & (depth > 0)
        & (depth < max_depth)
    )
    slots = ms.free_mp_slots(m, N)
    usable = ~m.mp_valid[slots]
    take = need & usable  # [N] aligned: feature n -> slots[n]

    R = m.kf_R[slot]
    t = m.kf_t[slot]
    xy = m.kf_xy[slot]
    xc = jnp.stack(
        [
            (xy[:, 0] - cam.cx) / cam.fx * depth,
            (xy[:, 1] - cam.cy) / cam.fy * depth,
            depth,
        ],
        axis=1,
    )
    xw = (xc - t) @ R  # R^T (xc - t)

    mp_pos = m.mp_pos.at[slots].set(jnp.where(take[:, None], xw, m.mp_pos[slots]))
    mp_valid = m.mp_valid.at[slots].max(take)
    mp_first = m.mp_first_kf.at[slots].set(
        jnp.where(take, m.n_kf - 1, m.mp_first_kf[slots])
    )
    obs_new = jnp.where(take, slots.astype(jnp.int32), m.kf_obs[slot])
    m = m._replace(
        mp_pos=mp_pos, mp_valid=mp_valid, mp_first_kf=mp_first,
        kf_obs=m.kf_obs.at[slot].set(obs_new),
        mp_visible=m.mp_visible.at[slots].set(
            jnp.where(take, 1, m.mp_visible[slots])
        ),
        mp_found=m.mp_found.at[slots].set(jnp.where(take, 1, m.mp_found[slots])),
    )
    if update_stats:
        m = ms.update_mappoint_stats(m)
    return m


@partial(jax.jit, static_argnames=("update_stats",))
def cull_recent_mappoints(m: ms.MapState, update_stats: bool = True) -> ms.MapState:
    """MapPointCulling rules (LocalMapping.cc:227-250):

    recent points (created within the last 3 keyframes) are dropped if
    found/visible < 0.25, or if 2+ keyframes have passed since creation
    and the point has <= 2 observations (mono thObs=2).  Points older
    than 3 keyframes graduate and are no longer tested.
    """
    cur = m.n_kf - 1
    age = cur - m.mp_first_kf
    recent = m.mp_valid & (m.mp_first_kf >= 0) & (age <= 4)
    found_ratio = m.mp_found.astype(jnp.float32) / jnp.maximum(
        m.mp_visible.astype(jnp.float32), 1.0
    )
    n_obs = ms.mp_observation_counts(m)
    # thresholds are softer than the reference's (0.25 / age>=2&obs<=2):
    # our keyframe cadence is sparser, so points legitimately take longer
    # to accumulate a third observation
    bad = recent & (found_ratio < 0.15) & (n_obs <= 2)
    mp_valid = m.mp_valid & ~bad
    # detach culled points from keyframe observations
    obs = m.kf_obs
    obs_bad = (obs >= 0) & bad[jnp.clip(obs, 0)]
    return m._replace(mp_valid=mp_valid, kf_obs=jnp.where(obs_bad, -1, obs))


def _fundamental_between(cam: CameraModel, R1, t1, R2, t2):
    """F12 such that x1^T F12 x2 = 0 for pixel coords (ComputeF12,
    LocalMapping.cc:597)."""
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    K = cam.K
    Kinv = jnp.linalg.inv(K)
    E12 = lie.hat(t12) @ R12
    return Kinv.T @ E12 @ Kinv


@partial(jax.jit, static_argnums=(3,), static_argnames=("update_stats",))
def create_new_mappoints(m: ms.MapState, cam: CameraModel, slot,
                         n_neighbors: int = 20,
                         update_stats: bool = True) -> ms.MapState:
    """Triangulate new points between the new keyframe and its best
    covisible neighbors (CreateNewMapPoints, LocalMapping.cc:253-509;
    20 mono neighbors like the reference).

    Batched shape: per-neighbor epipolar-gated dense matching (static
    n_neighbors), then each unmatched feature keeps its single best
    neighbor match, all triangulations happen as one vmapped batch, and
    surviving candidates are scattered into free map-point slots.

    Neighbor SELECTION applies the baseline/median-depth gate
    (LocalMapping.cc:294-310): ranking purely by covisibility picks the
    temporally-closest keyframes, whose baselines are too short to
    triangulate — under a fast keyframe cadence every selected neighbor
    then fails the gate and map-point creation starves exactly when the
    view turns to fresh scenery (the r2 'association decay', RESULTS.md).
    """
    K, P, N = m.K, m.P, m.N
    n_neighbors = min(n_neighbors, K - 1)  # small-capacity maps
    w_row = ms.covis_row(m, slot)  # only W[slot] is needed (the full
    # covisibility is O(K*P) at grown tiers)

    R1, t1 = m.kf_R[slot], m.kf_t[slot]
    c1 = -R1.T @ t1

    # median scene depth of the NEW keyframe (for the selection gate)
    obs_s = m.kf_obs[slot]
    has_s = (obs_s >= 0) & m.kf_feat_valid[slot]
    zs_s = jnp.where(
        has_s, (m.mp_pos[jnp.clip(obs_s, 0)] @ R1.T + t1)[:, 2], jnp.nan)
    med_depth_s = jnp.nan_to_num(jnp.nanmedian(zs_s), nan=1.0)
    cam_c = -jnp.einsum("kij,ki->kj", m.kf_R, m.kf_t)       # [K,3]
    base_all = jnp.linalg.norm(cam_c - c1, axis=-1)          # [K]
    base_ok = base_all / jnp.maximum(med_depth_s, 1e-6) > 0.01

    w_slot = jnp.where(m.kf_valid & base_ok, w_row, -1).at[slot].set(-1)
    _, nbrs = jax.lax.top_k(w_slot, n_neighbors)
    nbr_ok = w_slot[nbrs] > 0
    f1 = Frame(
        xy=m.kf_xy[slot], xy_raw=m.kf_xy[slot], ur=m.kf_ur[slot],
        depth=m.kf_depth[slot], octave=m.kf_octave[slot],
        angle=m.kf_angle[slot], response=jnp.zeros((N,)),
        desc=m.kf_desc[slot], valid=m.kf_feat_valid[slot],
    )
    has1 = m.kf_obs[slot] >= 0
    inv_s2 = _inv_sigma2(jnp.arange(N_LEVELS))

    def match_neighbor(nb):
        R2, t2 = m.kf_R[nb], m.kf_t[nb]
        c2 = -R2.T @ t2
        baseline = jnp.linalg.norm(c2 - c1)
        # baseline/median-depth gate (LocalMapping.cc:294-310, mono)
        obs_nb = m.kf_obs[nb]
        has_nb = (obs_nb >= 0) & m.kf_feat_valid[nb]
        zs = jnp.where(
            has_nb, (m.mp_pos[jnp.clip(obs_nb, 0)] @ R2.T + t2)[:, 2], jnp.nan
        )
        med_depth = jnp.nan_to_num(jnp.nanmedian(zs), nan=1.0)
        ok_baseline = baseline / jnp.maximum(med_depth, 1e-6) > 0.01

        F12 = _fundamental_between(cam, R1, t1, R2, t2)
        f2 = Frame(
            xy=m.kf_xy[nb], xy_raw=m.kf_xy[nb], ur=m.kf_ur[nb],
            depth=m.kf_depth[nb], octave=m.kf_octave[nb],
            angle=m.kf_angle[nb], response=jnp.zeros((N,)),
            desc=m.kf_desc[nb], valid=m.kf_feat_valid[nb],
        )
        has2 = m.kf_obs[nb] >= 0
        res = matching.search_for_triangulation(
            f1, f2, F12, inv_s2, inv_s2, exclude1=has1, exclude2=has2
        )
        ok = res.matched & ok_baseline
        return jnp.where(ok, res.idx, -1), jnp.where(ok, res.dist, 2048)

    idxs, dists = jax.vmap(match_neighbor)(nbrs)  # [NB, N] each
    idxs = jnp.where(nbr_ok[:, None], idxs, -1)
    dists = jnp.where(nbr_ok[:, None] & (idxs >= 0), dists, 2048)

    # --- triangulate and gate EVERY (neighbor, feature) pair, then let
    # each feature keep its best VALID pair.  Collapsing to the best-
    # descriptor neighbor FIRST (the r2 design) routes most features to
    # the temporally-closest match, which then dies on the parallax gate
    # — the reference avoids this by looping every pair
    # (CreateNewMapPoints, LocalMapping.cc:285).  [NB, N] batched DLT is
    # a few thousand tiny solves in one batch.
    K1m = cam.K
    P1 = K1m @ jnp.concatenate([R1, t1[:, None]], axis=1)  # [3,4]
    x1 = m.kf_xy[slot]
    s2_1 = SCALE ** (2.0 * m.kf_octave[slot].astype(jnp.float32))

    def tri_neighbor(nb, idx):
        """Triangulate + gate one neighbor's matches: returns
        (good [N], X [N,3], cosp [N])."""
        has = idx >= 0
        idc = jnp.clip(idx, 0)
        R2, t2 = m.kf_R[nb], m.kf_t[nb]
        P2 = K1m @ jnp.concatenate([R2, t2[:, None]], axis=1)
        x2 = m.kf_xy[nb, idc]
        X = jax.vmap(triangulate_dlt, in_axes=(None, None, 0, 0))(
            P1, P2, x1, x2)
        xc1 = X @ R1.T + t1
        xc2 = X @ R2.T + t2
        uv1 = project(cam, xc1)
        uv2 = project(cam, xc2)
        oct2 = m.kf_octave[nb, idc]
        s2_2 = SCALE ** (2.0 * oct2.astype(jnp.float32))
        e1 = jnp.sum((uv1 - x1) ** 2, axis=1)
        e2 = jnp.sum((uv2 - x2) ** 2, axis=1)
        c2v = -R2.T @ t2
        r1v = X - c1
        r2v = X - c2v
        cosp = jnp.sum(r1v * r2v, axis=1) / jnp.maximum(
            jnp.linalg.norm(r1v, axis=1) * jnp.linalg.norm(r2v, axis=1),
            1e-9)
        d1 = jnp.linalg.norm(r1v, axis=1)
        d2 = jnp.linalg.norm(r2v, axis=1)
        ratio_d = d1 / jnp.maximum(d2, 1e-9)
        ratio_o = (SCALE ** m.kf_octave[slot].astype(jnp.float32)) / (
            SCALE ** oct2.astype(jnp.float32))
        scale_ok = ((ratio_d < ratio_o * SCALE * 1.5)
                    & (ratio_d * SCALE * 1.5 > ratio_o))
        good = (
            has
            & jnp.all(jnp.isfinite(X), axis=1)
            & (xc1[:, 2] > 0)
            & (xc2[:, 2] > 0)
            & (e1 < 5.991 * s2_1)
            & (e2 < 5.991 * s2_2)
            & (cosp < 0.9998)
            & scale_ok
        )
        return good, X, cosp

    good_all, X_all, cosp_all = jax.vmap(tri_neighbor)(nbrs, idxs)
    # best valid pair per feature = largest parallax (smallest cosp)
    pick_score = jnp.where(good_all, cosp_all, jnp.inf)     # [NB, N]
    best_nb = jnp.argmin(pick_score, axis=0)                 # [N]
    has_match = jnp.any(good_all, axis=0)
    take_nb = best_nb[None, :]
    best_idx = jnp.take_along_axis(idxs, take_nb, axis=0)[0]
    X = jnp.take_along_axis(
        X_all, take_nb[..., None], axis=0)[0]                # [N,3]
    nb_sel = nbrs[best_nb]
    good = has_match

    # --- allocate slots & write
    slots = ms.free_mp_slots(m, N)
    usable = ~m.mp_valid[slots]
    take = good & usable

    mp_pos = m.mp_pos.at[slots].set(jnp.where(take[:, None], X, m.mp_pos[slots]))
    mp_valid = m.mp_valid.at[slots].max(take)
    mp_first = m.mp_first_kf.at[slots].set(
        jnp.where(take, m.n_kf - 1, m.mp_first_kf[slots])
    )
    mp_vis = m.mp_visible.at[slots].set(jnp.where(take, 1, m.mp_visible[slots]))
    mp_fnd = m.mp_found.at[slots].set(jnp.where(take, 1, m.mp_found[slots]))

    new_ids = jnp.where(take, slots.astype(jnp.int32), -1)  # per f1 feature
    obs1 = jnp.where(take, new_ids, m.kf_obs[slot])
    kf_obs = m.kf_obs.at[slot].set(obs1)
    # neighbor-side observation: scatter per neighbor row
    kf_obs = kf_obs.at[nb_sel, jnp.clip(best_idx, 0)].max(
        jnp.where(take, new_ids, -1)
    )
    m = m._replace(
        mp_pos=mp_pos, mp_valid=mp_valid, mp_first_kf=mp_first,
        mp_visible=mp_vis, mp_found=mp_fnd, kf_obs=kf_obs,
    )
    if update_stats:
        # bounded refresh: the chain only touched the covisible window's
        # points (a full pass OOMs at grown P tiers — map_state.
        # update_mappoint_geometry docstring)
        m = ms.update_mappoint_stats_touched(m, window_touched_points(m, slot))
    return m


def _fuse_targets_core(m: ms.MapState, cam: CameraModel,
                       targets, tgt_ok, src_masks,
                       max_cand: int = 1024, ratio: float = 0.9,
                       do_add: bool = True, do_merge: bool = True,
                       e2_gate: float = 2.0, max_dist: int = matching.TH_LOW):
    """Shared projection-fuse machinery (ORBmatcher::Fuse:940 +
    MapPoint::Replace:194 as a remap table).

    targets [T] keyframe slots; tgt_ok [T] bool; src_masks [T, P]
    source-point mask per target.  For every (target, source point)
    pair where the point projects onto a consistent target feature:
      * feature has no point      -> add the association
      * feature has another point -> merge (more observations wins)
    Returns the updated MapState (kf_obs rewritten through the remap,
    losers invalidated).  Callers: fuse_neighbors (SearchInNeighbors,
    LocalMapping.cc:511) and loop closing's SearchAndFuse
    (LoopClosing.cc:689).
    """
    K, P, N = m.K, m.P, m.N
    MAXC = min(max_cand, P)

    def fuse_into(tkf, src_mask):
        """Returns (feat_match [N] point id or -1, dist)."""
        R, t = m.kf_R[tkf], m.kf_t[tkf]
        xc = m.mp_pos @ R.T + t
        uv = project(cam, xc)
        cam_center = -R.T @ t
        dvec = m.mp_pos - cam_center
        dist = jnp.linalg.norm(dvec, axis=-1)
        vcos = jnp.sum(dvec * m.mp_normal, axis=-1) / jnp.maximum(dist, 1e-9)
        okp = (
            src_mask
            & (xc[:, 2] > 0.05)
            & in_image(cam, uv)
            & (dist >= m.mp_min_dist)
            & (dist <= m.mp_max_dist)
            & (vcos > 0.5)
        )
        dist_ratio = jnp.maximum(m.mp_max_dist / jnp.maximum(dist, 1e-9), 1.0)
        # clip to the pyramid's actual top level (PredictScale,
        # MapPoint.cc:449) — a hardcoded 8-level clip would send
        # predictions past every octave gate on shallower pyramids
        top_oct = jnp.max(jnp.where(m.kf_feat_valid, m.kf_octave, 0))
        pred_oct = jnp.clip(
            jnp.ceil(jnp.log(dist_ratio) / jnp.log(SCALE)).astype(jnp.int32),
            0, top_oct,
        )
        _, cand = jax.lax.top_k(okp.astype(jnp.int32), MAXC)
        cvalid = okp[cand]
        radius = 3.0 * (SCALE ** pred_oct[cand].astype(jnp.float32))

        fr = Frame(
            xy=m.kf_xy[tkf], xy_raw=m.kf_xy[tkf], ur=m.kf_ur[tkf],
            depth=m.kf_depth[tkf], octave=m.kf_octave[tkf],
            angle=m.kf_angle[tkf], response=jnp.zeros((N,)),
            desc=m.kf_desc[tkf], valid=m.kf_feat_valid[tkf],
        )
        res = matching.search_map_points(
            m.mp_desc[cand], cvalid, uv[cand], pred_oct[cand], radius, fr,
            ratio=ratio, max_dist=max_dist,
        )
        # geometric gates beyond the matcher's window: tight reprojection
        # residual and (when the feature has depth) depth agreement.  The
        # reference leans on ORB distinctiveness alone (Fuse, :940); our
        # descriptors need the geometry to veto repetitive-texture matches.
        tgt = jnp.clip(res.idx, 0)
        sig2 = SCALE ** (2.0 * m.kf_octave[tkf][tgt].astype(jnp.float32))
        e2 = jnp.sum((uv[cand] - m.kf_xy[tkf][tgt]) ** 2, axis=1)
        z_pt = xc[cand][:, 2]
        f_depth = m.kf_depth[tkf][tgt]
        depth_ok = (f_depth <= 0) | (jnp.abs(z_pt - f_depth) < 0.05 * f_depth)
        ok = res.matched & (e2 < e2_gate * sig2) & depth_ok
        # per-feature best source point
        feat_pt = jnp.full((N,), -1, jnp.int32).at[tgt].max(
            jnp.where(ok, cand.astype(jnp.int32), -1)
        )
        return feat_pt

    feat_pt_all = jax.vmap(fuse_into)(targets, src_masks)
    feat_pt_all = jnp.where(tgt_ok[:, None], feat_pt_all, -1)  # [T, N]

    # --- resolve: existing obs vs proposed point
    existing = m.kf_obs[targets]  # [T, N]
    prop = feat_pt_all
    n_obs = ms.mp_observation_counts(m)

    add_mask = (existing < 0) & (prop >= 0) & do_add
    merge_mask = (existing >= 0) & (prop >= 0) & (existing != prop) & do_merge
    # geometric gate: only merge points that are actually close in 3D —
    # duplicates from re-triangulation are; matches on repetitive texture
    # are not (the reference trusts ORB descriptor distinctiveness here,
    # ORBmatcher::Fuse:940; ours need the extra check)
    p_ex = m.mp_pos[jnp.clip(existing, 0)]
    p_pr = m.mp_pos[jnp.clip(prop, 0)]
    d3 = jnp.linalg.norm(p_ex - p_pr, axis=-1)
    # scale the agreement gate by distance from the OBSERVING camera
    # (distance from the world origin says nothing about parallax)
    # camera center = -R^T t; einsum "tij,ti->tj" contracts the FIRST
    # matrix index (computes A^T v), so pass R itself — no transpose
    cam_c = -jnp.einsum("tij,ti->tj", m.kf_R[targets], m.kf_t[targets])  # [T,3]
    depth_scale = jnp.maximum(
        jnp.linalg.norm(p_ex - cam_c[:, None, :], axis=-1), 1e-3)
    merge_mask &= d3 < 0.015 * depth_scale

    # merge: winner = more observations; remap loser -> winner
    ex = jnp.clip(existing, 0)
    pr = jnp.clip(prop, 0)
    ex_wins = n_obs[ex] >= n_obs[pr]
    loser = jnp.where(ex_wins, pr, ex)
    winner = jnp.where(ex_wins, ex, pr)

    remap = jnp.arange(P + 1, dtype=jnp.int32)  # slot P = scatter dump
    remap = remap.at[jnp.where(merge_mask, loser, P).reshape(-1)].set(
        jnp.where(merge_mask, winner, P).reshape(-1)
    )
    remap = remap[:P]
    # a loser merging into a loser: resolve 2-chains with one extra pass
    remap = remap[remap]

    new_obs_rows = jnp.where(add_mask, prop, existing)
    # invalid filler targets may alias real slots — route them to a dump row
    obs_tgt = jnp.where(tgt_ok, targets, K)
    kf_obs = jnp.concatenate(
        [m.kf_obs, jnp.zeros((1, N), jnp.int32)], 0
    ).at[obs_tgt].set(new_obs_rows)[:K]
    live = remap == jnp.arange(P)
    kf_obs = jnp.where(kf_obs >= 0, remap[jnp.clip(kf_obs, 0)], -1)
    return m._replace(kf_obs=kf_obs, mp_valid=m.mp_valid & live)


@partial(jax.jit, static_argnums=(3,),
         static_argnames=("update_stats", "do_add", "do_merge", "e2_gate",
                          "ratio", "max_dist"))
def fuse_neighbors(m: ms.MapState, cam: CameraModel, slot,
                   n_neighbors: int = 10,
                   update_stats: bool = True,
                   do_add: bool = True, do_merge: bool = True,
                   e2_gate: float = 2.0, ratio: float = 0.9,
                   max_dist: int = matching.TH_LOW) -> ms.MapState:
    """Two-way map-point fusion with covisible neighbors
    (SearchInNeighbors, LocalMapping.cc:511-594 + ORBmatcher::Fuse:940).

    Targets = the new keyframe and its n_neighbors best covisible KFs;
    sources = points of the counterpart side (the neighbors' points fuse
    into the new keyframe; the new keyframe's points fuse into each
    neighbor)."""
    P = m.P
    n_neighbors = min(n_neighbors, m.K - 1)  # small-capacity maps
    w_slot = jnp.where(m.kf_valid, ms.covis_row(m, slot), -1).at[slot].set(-1)
    _, nbrs = jax.lax.top_k(w_slot, n_neighbors)
    nbr_ok = w_slot[nbrs] > 0
    targets = jnp.concatenate([jnp.asarray([slot]), nbrs])       # [T]
    tgt_ok = jnp.concatenate([jnp.asarray([True]), nbr_ok])

    own_pts_slot = jnp.zeros((P,), bool).at[jnp.clip(m.kf_obs[slot], 0)].max(
        m.kf_obs[slot] >= 0
    )
    nbr_pts = jnp.zeros((P,), bool)
    for i in range(n_neighbors):  # static loop, scatter per neighbor
        o = m.kf_obs[nbrs[i]]
        nbr_pts = nbr_pts.at[jnp.clip(o, 0)].max((o >= 0) & nbr_ok[i])
    src_for_slot = nbr_pts & m.mp_valid          # fuse neighbors' pts into slot
    src_for_nbr = own_pts_slot & m.mp_valid      # fuse slot's pts into neighbors
    src_masks = jnp.concatenate(
        [src_for_slot[None], jnp.broadcast_to(src_for_nbr, (n_neighbors, P))], 0
    )

    m = _fuse_targets_core(m, cam, targets, tgt_ok, src_masks,
                           do_add=do_add, do_merge=do_merge,
                           e2_gate=e2_gate, ratio=ratio, max_dist=max_dist)
    if update_stats:
        m = ms.update_mappoint_stats_touched(m, window_touched_points(m, slot))
    return m


@partial(jax.jit, static_argnames=("update_stats",))
def fuse_points_into(m: ms.MapState, cam: CameraModel, targets, tgt_ok,
                     src_mask, update_stats: bool = True) -> ms.MapState:
    """SearchAndFuse for loop closing (LoopClosing.cc:609-636, 689):
    project one shared set of source points (the loop neighborhood's map
    points) into every target keyframe (the corrected covisible group)
    and fuse duplicates across the loop seam.

    targets [T] i32, tgt_ok [T] bool, src_mask [P] bool.
    """
    T = targets.shape[0]
    src_masks = jnp.broadcast_to(src_mask & m.mp_valid, (T, m.P))
    m = _fuse_targets_core(m, cam, targets, tgt_ok, src_masks, ratio=0.8)
    if update_stats:
        m = ms.update_mappoint_stats(m)
    return m


class LocalBAOut(NamedTuple):
    map: ms.MapState
    n_edges: jnp.ndarray
    cost: jnp.ndarray


@partial(jax.jit, static_argnums=(3, 4), static_argnames=("update_stats",), donate_argnums=(0,))
def local_bundle_adjustment(m: ms.MapState, cam: CameraModel, slot,
                            n_opt: int = 16, n_fixed: int = 16,
                            update_stats: bool = True) -> LocalBAOut:
    """Covisible-window BA (Optimizer::LocalBundleAdjustment:483-813).

    Optimizable cameras: the new KF + its best covisible; fixed cameras:
    other observers of the local points (capped).  Points: everything the
    optimizable set observes.  Edge list is the dense [C_all, N] grid of
    (keyframe-feature, point) associations masked to the point set.
    """
    K, P, N = m.K, m.P, m.N
    n_opt = min(n_opt, K)        # small-capacity maps
    n_fixed = min(n_fixed, K)
    w_slot = jnp.where(m.kf_valid, ms.covis_row(m, slot), -1).at[slot].set(-1)
    _, nb = jax.lax.top_k(w_slot, n_opt - 1)
    opt_kfs = jnp.concatenate([jnp.asarray([slot]), nb])  # [n_opt]
    opt_ok = jnp.concatenate([jnp.asarray([True]), w_slot[nb] > 0])

    # local point set + fixed frontier WITHOUT the [K,P] observation
    # matrix (its K*N-update scatter scales with capacity): an n_opt*N
    # scatter for the window's
    # point mask, then a gather of that mask at every observation
    pts_mask = ms.point_mask_rows(m, opt_kfs, opt_ok) & m.mp_valid  # [P]

    # fixed frontier: other KFs seeing local points
    all_ok = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    sees_local = jnp.any(
        pts_mask[jnp.clip(m.kf_obs, 0)] & all_ok, axis=1)  # [K]
    is_opt = jnp.zeros((K,), bool).at[opt_kfs].max(opt_ok)
    fixed_cand = sees_local & m.kf_valid & ~is_opt
    _, fx = jax.lax.top_k(fixed_cand.astype(jnp.int32), n_fixed)
    fx_ok = fixed_cand[fx]

    cams_all = jnp.concatenate([opt_kfs, fx])          # [C]
    cams_ok = jnp.concatenate([opt_ok, fx_ok])
    cam_fixed = jnp.concatenate(
        [jnp.zeros((n_opt,), bool), jnp.ones((n_fixed,), bool)]
    )
    C = n_opt + n_fixed
    # gauge: with no valid fixed frontier the problem is free-floating —
    # anchor the oldest optimizable KF (the reference fixes KF id 0 in
    # GBA, Optimizer.cc:90; scale drifts slowly through the damped LM,
    # as in the reference's mono local BA)
    no_frontier = ~jnp.any(fx_ok)
    oldest = jnp.argmin(
        jnp.where(opt_ok, m.kf_frame_id[opt_kfs], jnp.iinfo(jnp.int32).max)
    )
    cam_fixed = cam_fixed.at[oldest].set(cam_fixed[oldest] | no_frontier)

    # local point index: compact to P_BA slots
    P_BA = min(2048, P)
    _, psel = jax.lax.top_k(pts_mask.astype(jnp.int32), P_BA)
    psel_ok = pts_mask[psel]
    g2l = jnp.full((P,), -1, jnp.int32).at[psel].set(
        jnp.where(psel_ok, jnp.arange(P_BA, dtype=jnp.int32), -1)
    )

    # edges: every (c, n) of cams_all with obs in the point set — kept as
    # the [C, N] grid so the BA engine assembles normal equations with
    # gathers instead of scatters (ba_core.bundle_adjust_grid)
    obs_grid = m.kf_obs[cams_all]  # [C, N]
    feat_ok = m.kf_feat_valid[cams_all] & cams_ok[:, None]
    pt_loc = jnp.where(feat_ok & (obs_grid >= 0),
                       g2l[jnp.clip(obs_grid, 0)], -1)
    e_valid = feat_ok & (pt_loc >= 0)
    octv = m.kf_octave[cams_all]

    prob = ba_core.GridBA(
        R=m.kf_R[cams_all], t=m.kf_t[cams_all],
        points=m.mp_pos[psel],
        cam_fixed=cam_fixed | ~cams_ok,
        cam_valid=cams_ok,
        pt_valid=psel_ok,
        pt_loc=pt_loc.astype(jnp.int32),
        uv=m.kf_xy[cams_all], ur=m.kf_ur[cams_all],
        inv_sigma2=_inv_sigma2(octv), edge_valid=e_valid,
    )
    # robust iters, outlier re-mask, more iters (the reference's 5-then-10
    # schedule, Optimizer.cc:668-704 — here 4+6: each of our iterations
    # retries 3 damping values per linearization, so 10 linearizations
    # make at least as much progress as g2o's 15 solver iterations, and
    # local BA is the throughput ceiling of the whole keyframe chain)
    R1, t1, X1, inl1, _ = ba_core.bundle_adjust_grid(
        cam, prob, iters=LBA_ITERS_ROBUST, robust=True)
    prob2 = prob._replace(R=R1, t=t1, points=X1, edge_valid=e_valid & inl1)
    R2, t2, X2, inl2, cost = ba_core.bundle_adjust_grid(
        cam, prob2, iters=LBA_ITERS_FINAL, robust=True)
    ev = e_valid.reshape(-1)
    inl2 = inl2.reshape(-1)

    # --- write back poses & points.  Invalid slots in cams_all/psel are
    # top_k filler indices that may ALIAS valid slots elsewhere in the
    # list; scattering them (even with old values) races against the
    # real update.  Route them to a dump row instead.
    upd_cam = cams_ok & ~cam_fixed
    cam_tgt = jnp.where(upd_cam, cams_all, K)  # K = dump row
    kf_R = jnp.concatenate([m.kf_R, jnp.zeros((1, 3, 3))], 0).at[cam_tgt].set(R2)[:K]
    kf_t = jnp.concatenate([m.kf_t, jnp.zeros((1, 3))], 0).at[cam_tgt].set(t2)[:K]
    pt_tgt = jnp.where(psel_ok, psel, P)
    mp_pos = jnp.concatenate([m.mp_pos, jnp.zeros((1, 3))], 0).at[pt_tgt].set(X2)[:P]

    # --- drop outlier observations (Optimizer.cc:747-767)
    bad_edge = (ev & ~inl2).reshape(C, N)
    obs_rows = jnp.where(bad_edge, -1, m.kf_obs[cams_all])
    obs_tgt = jnp.where(cams_ok, cams_all, K)
    kf_obs = jnp.concatenate(
        [m.kf_obs, jnp.zeros((1, N), jnp.int32)], 0
    ).at[obs_tgt].set(obs_rows)[:K]

    m = m._replace(kf_R=kf_R, kf_t=kf_t, mp_pos=mp_pos, kf_obs=kf_obs)
    if update_stats:
        m = ms.update_mappoint_stats(m)
    return LocalBAOut(m, jnp.sum(ev), cost)


class CullInfo(NamedTuple):
    """Reparenting data for frame-trajectory records whose reference
    keyframe was culled (System.cc:366-371 walks the spanning tree at
    save time; we rewrite records eagerly from this prefetched bundle)."""
    slots: jnp.ndarray    # [max_cull] dropped slot ids
    ok: jnp.ndarray       # [max_cull] bool
    new_ref: jnp.ndarray  # [max_cull] surviving replacement slot
    R_rel: jnp.ndarray    # [max_cull,3,3]  Trel = T_old * T_new^-1
    t_rel: jnp.ndarray    # [max_cull,3]


@partial(jax.jit, static_argnums=(2,), static_argnames=("update_stats",))
def cull_keyframes(m: ms.MapState, protect_slot,
                   max_cull: int = 4,
                   update_stats: bool = True) -> tuple[ms.MapState, CullInfo]:
    """Redundant-keyframe culling (KeyFrameCulling, LocalMapping.cc:710):
    a local keyframe whose map points are >= 90% observed by at least 3
    OTHER keyframes at the same or finer scale is dropped.

    Candidates are restricted to the covisible window of `protect_slot`
    (the reference iterates mpCurrentKeyFrame->GetVectorCovisibleKeyFrames
    only, LocalMapping.cc:712), which keeps the redundancy gather at
    [C_WIN, N, MAX_OBS] instead of [K, N, MAX_OBS] as the map grows.
    At most `max_cull` keyframes are removed per call (newest keyframes
    and the protected slot are exempt).
    """
    K, P, N = m.K, m.P, m.N
    C_WIN = min(24, K)
    obs_kf, obs_ft, obs_cnt, obs_mask = ms.observation_table(m)
    obs_oct = m.kf_octave[obs_kf, obs_ft]  # [P, MAX_OBS]

    w_slot = jnp.where(m.kf_valid, ms.covis_row(m, protect_slot), -1)
    w_slot = w_slot.at[protect_slot].set(-1)
    _, win = jax.lax.top_k(w_slot, C_WIN)                 # [C_WIN] slots
    win_ok = w_slot[win] > 0

    # for every (c, n) of the window: its point's observers at octave
    # <= oct(c,n)+1, excluding the window keyframe itself
    pid = jnp.clip(m.kf_obs[win], 0)                      # [C_WIN, N]
    has = (m.kf_obs[win] >= 0) & m.kf_feat_valid[win] & win_ok[:, None]
    oct_kn = m.kf_octave[win]                             # [C_WIN, N]
    # gather per-point observer tables: [C_WIN, N, MAX_OBS]
    o_kf = obs_kf[pid]
    o_oct = obs_oct[pid]
    o_msk = obs_mask[pid]
    fine = o_msk & (o_oct <= oct_kn[..., None] + 1) & (
        o_kf != win[:, None, None]
    )
    n_redundant = jnp.sum(fine, axis=-1)                  # [C_WIN, N]
    red = has & (n_redundant >= 3)
    n_obs_kf = jnp.sum(has, axis=1)
    n_red_kf = jnp.sum(red, axis=1)
    ratio_win = n_red_kf / jnp.maximum(n_obs_kf, 1)       # [C_WIN]
    # scatter window ratios back to [K] (invalid window slots -> dump row)
    ratio = jnp.zeros((K + 1,)).at[
        jnp.where(win_ok, win, K)].set(ratio_win)[:K]

    # protect: invalid slots, the newest 3 keyframes, the protected slot
    fid = m.kf_frame_id
    order = jnp.argsort(-jnp.where(m.kf_valid, fid, -1))
    newest = jnp.zeros((K,), bool).at[order[:3]].set(True)
    cand = m.kf_valid & ~newest & (ratio >= 0.9)
    cand = cand.at[protect_slot].set(False)
    # cull onset: never shrink a bootstrap map (the host policy enables
    # culling only once the map holds > 8 keyframes; this device-side
    # gate makes the free-running path — which cannot read the count —
    # behave identically)
    cand &= jnp.sum(m.kf_valid) > 8

    # drop up to max_cull, most-redundant first
    score = jnp.where(cand, ratio, -1.0)
    _, drop = jax.lax.top_k(score, max_cull)
    drop_ok = score[drop] > 0
    kf_valid = m.kf_valid.at[drop].set(
        jnp.where(drop_ok, False, m.kf_valid[drop])
    )
    # clear dropped rows' observations
    row_clear = jnp.zeros((K,), bool).at[drop].max(drop_ok)
    kf_obs = jnp.where(row_clear[:, None], -1, m.kf_obs)

    # reparent info: strongest surviving covisible of each dropped KF
    # (falls back to the newest surviving keyframe).  Only the <=max_cull
    # dropped rows of W are needed — covis_rows, not the full matrix.
    W_drop = ms.covis_rows(m, drop, drop_ok)     # [max_cull, K]
    newest_valid = jnp.argmax(jnp.where(kf_valid, fid, -1))

    def reparent(d, w_d):
        w_row = jnp.where(kf_valid, w_d, -1)
        ref = jnp.argmax(w_row)
        ref = jnp.where(w_row[ref] > 0, ref, newest_valid).astype(jnp.int32)
        R_old, t_old = m.kf_R[d], m.kf_t[d]
        R_new, t_new = m.kf_R[ref], m.kf_t[ref]
        R_rel = R_old @ R_new.T
        t_rel = t_old - R_rel @ t_new
        return ref, R_rel, t_rel

    new_ref, R_rel, t_rel = jax.vmap(reparent)(drop, W_drop)
    info = CullInfo(drop.astype(jnp.int32), drop_ok, new_ref, R_rel, t_rel)

    m = m._replace(kf_valid=kf_valid, kf_obs=kf_obs)
    if update_stats:
        m = ms.update_mappoint_stats(m)
    return m, info


@partial(jax.jit, static_argnames=("has_depth", "do_cull_recent",
                                   "stats_in_triangulate", "do_fuse",
                                   "do_local_ba", "do_kf_cull"))
def keyframe_chain(m: ms.MapState, cam: CameraModel, frame: Frame,
                   R, t, obs, frame_id, timestamp, max_depth,
                   has_depth: bool = False, do_cull_recent: bool = True,
                   stats_in_triangulate: bool = False,
                   do_fuse: bool = False, do_local_ba: bool = True,
                   do_kf_cull: bool = True):
    """The WHOLE per-keyframe mapping chain as ONE device program:
    insert -> (depth points) -> recent-point cull -> triangulate ->
    (fuse) -> local BA -> keyframe cull -> windowed stats refresh.

    The stages exist separately above for unit tests and ablation; the
    live System dispatches this fused version: one dispatch per
    keyframe instead of eight.  Returns (map, slot, CullInfo).
    """
    m, slot = insert_keyframe_from_frame(
        m, frame, R, t, obs, frame_id, timestamp, update_stats=False)
    if has_depth:
        m = create_depth_mappoints(m, cam, slot, max_depth,
                                   update_stats=False)
    if do_cull_recent:
        m = cull_recent_mappoints(m)
    m = create_new_mappoints(m, cam, slot,
                             update_stats=stats_in_triangulate)
    if do_fuse:
        m = fuse_neighbors(m, cam, slot, update_stats=False)
    if do_local_ba:
        out = local_bundle_adjustment(m, cam, slot, update_stats=False)
        m = out.map
    if do_kf_cull:
        m, cull_info = cull_keyframes(m, slot, update_stats=False)
    else:
        z = jnp.zeros((4,), jnp.int32)
        cull_info = CullInfo(z, jnp.zeros((4,), bool), z,
                             jnp.zeros((4, 3, 3)), jnp.zeros((4, 3)))
    m = ms.update_mappoint_stats_touched(m, window_touched_points(m, slot))
    return m, slot, cull_info


@jax.jit
def window_touched_points(m: ms.MapState, slot) -> jnp.ndarray:
    """[P] mask of points the keyframe chain may have moved or
    re-associated: everything observed by the new keyframe's covisible
    window (the local-BA optimizable set + fusion targets).  Window is
    24 so it covers cull_keyframes' candidate window — points observed
    only by culled keyframes must get their stats refreshed too."""
    K = m.K
    n_win = min(24, K)
    w_slot = jnp.where(m.kf_valid, ms.covis_row(m, slot), -1).at[slot].set(-1)
    _, nb = jax.lax.top_k(w_slot, n_win - 1)
    kfs = jnp.concatenate([jnp.asarray([slot]), nb])
    ok = jnp.concatenate([jnp.asarray([True]), w_slot[nb] > 0])
    return ms.point_mask_rows(m, kfs, ok)
