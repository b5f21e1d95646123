"""Data-association suite: the counterparts of ORBmatcher's entry points.

Reference: ORBmatcher.cc — SearchByProjection x4 (:51,:335,:1484,:1641),
SearchByBoW x2 (:185,:610), SearchForInitialization (:469),
SearchForTriangulation (:754), SearchBySim3 (:1251), Fuse x2 (:940,:1112).

Design: the reference restricts brute-force comparisons with grid cells
and BoW feature-vector nodes because it is CPU-bound on Hamming distance.
On an accelerator the full [N1, N2] popcount matrix for N ~ 1024 is one
small fused elementwise pass, so every Search* becomes: (1) build a
boolean candidate mask
(spatial window / epipolar gate / scale consistency), (2) one dense
Hamming matrix, (3) masked best/second-best + ratio test, (4) rotation
histogram consistency, (5) optional mutual (cross) check.  Constants
TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 follow ORBmatcher.cc:37-39.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .hamming import MAX_DIST, hamming_pairwise, masked_min2

# Acceptance thresholds.  The reference uses 50/100 for OpenCV's learned
# 256-bit ORB pattern (ORBmatcher.cc:37-39); ours are re-tuned to the
# 512-bit margin-trained pattern's measured matched/random Hamming
# statistics (tools/eval_descriptors.py on the pattern from
# ops/pattern_train.py): matched p50=104 p75=159, random p5=143 p25=184
# -> TH_LOW at matched ~p75 (oblique views run high — RoomScene wall
# tracking dies below this), TH_HIGH between random p25 and p50 (the
# window/octave gates + ratio test carry the selectivity there).
TH_LOW = 134
TH_HIGH = 184
HISTO_LENGTH = 30


def rotation_consistency(angle1: jnp.ndarray, angle2: jnp.ndarray,
                         matched: jnp.ndarray) -> jnp.ndarray:
    """Keep only matches whose rotation offset falls in the 3 dominant bins.

    angle1: [N] radians of the source keypoints; angle2: [N] radians of the
    matched target keypoints (gathered); matched: [N] bool.
    Mirrors ORBmatcher ComputeThreeMaxima (:1777) + the bin pruning loops.
    """
    rot = (angle1 - angle2) % (2.0 * jnp.pi)
    bins = jnp.clip(
        jnp.round(rot * (HISTO_LENGTH / (2.0 * jnp.pi))).astype(jnp.int32),
        0,
        HISTO_LENGTH,
    ) % HISTO_LENGTH
    hist = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(matched.astype(jnp.int32))
    # keep the 3 dominant bins; bins 2/3 only if > 10% of bin 1
    # (ORBmatcher.cc:1800-1808)
    order = jnp.argsort(-hist)
    in_top = jnp.zeros(HISTO_LENGTH, bool)
    in_top = in_top.at[order[0]].set(True)
    in_top = in_top.at[order[1]].set(hist[order[1]].astype(jnp.float32) > 0.1 * hist[order[0]])
    in_top = in_top.at[order[2]].set(hist[order[2]].astype(jnp.float32) > 0.1 * hist[order[0]])
    return matched & in_top[bins]


class MatchResult(NamedTuple):
    idx: jnp.ndarray   # [N1] int32 index into set 2, -1 if unmatched
    dist: jnp.ndarray  # [N1] int32 Hamming distance (MAX_DIST if unmatched)

    @property
    def matched(self):
        return self.idx >= 0

    @property
    def count(self):
        return jnp.sum(self.idx >= 0)


def match_masked(desc1, desc2, cand_mask, max_dist=TH_LOW, ratio=1.0,
                 mutual=False) -> MatchResult:
    """Core masked matcher.

    desc1 [N1,8], desc2 [N2,8] u32; cand_mask [N1,N2] bool.
    ratio: best < ratio * second_best (1.0 disables).
    mutual: also require argmin over rows (cross-check), used where the
    reference guards against duplicate assignments.
    """
    d = hamming_pairwise(desc1, desc2)
    best, bidx, second = masked_min2(d, cand_mask)
    ok = (best <= max_dist) & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    if mutual:
        dm = jnp.where(cand_mask, d, MAX_DIST)
        rbest_idx = jnp.argmin(dm, axis=0)  # [N2] best row for each col
        ok = ok & (rbest_idx[bidx] == jnp.arange(desc1.shape[0]))
    else:
        # resolve duplicate column assignments: keep the best row per column
        dm = jnp.where(cand_mask, d, MAX_DIST)
        col_best = jnp.min(dm, axis=0)
        ok = ok & (best <= col_best[bidx])
    idx = jnp.where(ok, bidx, -1)
    dist = jnp.where(ok, best, MAX_DIST)
    return MatchResult(idx.astype(jnp.int32), dist)


def window_mask(xy1_proj: jnp.ndarray, xy2: jnp.ndarray, radius: jnp.ndarray):
    """Circular-window candidate mask.

    xy1_proj: [N1, 2] projected/predicted positions in image 2;
    xy2: [N2, 2] keypoint positions; radius: scalar or [N1].
    Replaces Frame::GetFeaturesInArea grid queries (Frame.cc:358) with a
    dense distance test.
    """
    # componentwise: two [N1,N2] planes instead of an [N1,N2,2]
    # intermediate with a size-2 minor axis
    dx = xy1_proj[:, None, 0] - xy2[None, :, 0]
    dy = xy1_proj[:, None, 1] - xy2[None, :, 1]
    d2 = dx * dx + dy * dy
    r = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), (xy1_proj.shape[0],))
    return d2 <= (r[:, None] ** 2)


def octave_mask(pred_octave: jnp.ndarray, octave2: jnp.ndarray,
                lo_off: int = -1, hi_off: int = 1):
    """Scale-consistency mask: octave2 within [pred+lo_off, pred+hi_off]."""
    o = pred_octave[:, None]
    return (octave2[None, :] >= o + lo_off) & (octave2[None, :] <= o + hi_off)


def search_for_initialization(f1, f2, window: float = 100.0,
                              ratio: float = 0.9) -> MatchResult:
    """Windowed matching for monocular initialization
    (ORBmatcher::SearchForInitialization:469): level-0 only, window px,
    ratio 0.9, rotation histogram, TH_LOW."""
    cand = window_mask(f1.xy, f2.xy, window)
    cand &= (f1.octave[:, None] == 0) & (f2.octave[None, :] == 0)
    cand &= f1.valid[:, None] & f2.valid[None, :]
    res = match_masked(f1.desc, f2.desc, cand, TH_LOW, ratio, mutual=False)
    ang2 = f2.angle[jnp.clip(res.idx, 0)]
    keep = rotation_consistency(f1.angle, ang2, res.matched)
    return MatchResult(jnp.where(keep, res.idx, -1), jnp.where(keep, res.dist, MAX_DIST))


def search_frame_to_frame(f_cur, f_last, proj_xy, proj_valid, pred_octave,
                          radius_px, ratio: float = 0.9,
                          max_dist: int = TH_HIGH) -> MatchResult:
    """Motion-model tracking match (SearchByProjection frame-to-last,
    ORBmatcher.cc:1484): last frame's map-point projections vs current
    keypoints within an octave-scaled radius.

    proj_xy: [N_last, 2] projections of last frame's points into current;
    radius_px: [N_last] search radii (already octave-scaled by caller).
    Returns per-last-feature match into current frame.
    """
    cand = window_mask(proj_xy, f_cur.xy, radius_px)
    cand &= octave_mask(pred_octave, f_cur.octave, -1, 1)
    cand &= proj_valid[:, None] & f_cur.valid[None, :]
    res = match_masked(f_last.desc, f_cur.desc, cand, max_dist, ratio)
    ang2 = f_cur.angle[jnp.clip(res.idx, 0)]
    keep = rotation_consistency(f_last.angle, ang2, res.matched)
    return MatchResult(jnp.where(keep, res.idx, -1), jnp.where(keep, res.dist, MAX_DIST))


def search_map_points(point_desc, point_valid, proj_xy, pred_octave, radius_px,
                      f_cur, ratio: float = 0.8, max_dist: int = TH_HIGH) -> MatchResult:
    """Track-local-map match (SearchByProjection over MapPoints,
    ORBmatcher.cc:51): each candidate map point (with its distinctive
    descriptor) searches current keypoints in a scaled window.

    point_desc: [P, 8]; proj_xy: [P, 2]; radius_px: [P]; pred_octave: [P].
    """
    cand = window_mask(proj_xy, f_cur.xy, radius_px)
    cand &= octave_mask(pred_octave, f_cur.octave, -1, 1)
    cand &= point_valid[:, None] & f_cur.valid[None, :]
    return match_masked(point_desc, f_cur.desc, cand, max_dist, ratio)


def search_for_triangulation(f1, f2, F12, inv_sigma2_1, inv_sigma2_2,
                             exclude1=None, exclude2=None) -> MatchResult:
    """Epipolar-gated matching for new map-point triangulation
    (ORBmatcher::SearchForTriangulation:754 + CheckDistEpipolarLine:156).

    F12: fundamental matrix mapping kp1 -> epipolar line in image 2.
    inv_sigma2_*: [n_levels] per-octave 1/sigma^2 tables.
    exclude*: bool [N] — features that already have map points.
    """
    x1h = jnp.concatenate([f1.xy, jnp.ones_like(f1.xy[:, :1])], axis=1)  # [N1,3]
    lines = x1h @ F12  # line in image 2 for each kp1: [N1, 3]
    x2h = jnp.concatenate([f2.xy, jnp.ones_like(f2.xy[:, :1])], axis=1)
    num = (lines @ x2h.T) ** 2  # [N1, N2]
    den = jnp.maximum(lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2, 1e-12)
    dsq = num / den
    # chi2(1dof) 3.84 * sigma2(octave of kp2)  (ORBmatcher.cc:172)
    sigma2_2 = 1.0 / inv_sigma2_2[f2.octave]
    epi_ok = dsq < 3.84 * sigma2_2[None, :]

    cand = epi_ok & f1.valid[:, None] & f2.valid[None, :]
    if exclude1 is not None:
        cand &= ~exclude1[:, None]
    if exclude2 is not None:
        cand &= ~exclude2[None, :]
    res = match_masked(f1.desc, f2.desc, cand, TH_LOW, ratio=1.0, mutual=False)
    ang2 = f2.angle[jnp.clip(res.idx, 0)]
    keep = rotation_consistency(f1.angle, ang2, res.matched)
    return MatchResult(jnp.where(keep, res.idx, -1), jnp.where(keep, res.dist, MAX_DIST))
