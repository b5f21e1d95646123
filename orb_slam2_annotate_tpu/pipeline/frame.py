"""Per-frame measurement record: the counterpart of Frame.cc.

A Frame bundles the extracted features with undistorted coordinates and
(for stereo/RGB-D) per-feature depth / virtual right-image coordinates.
Construction is one jitted program per sensor type:

* mono  (Frame.cc:179): extract + undistort
* rgbd  (Frame.cc:119): + depth lookup at keypoints -> ur = u - bf/d
  (ComputeStereoFromRGBD, Frame.cc:689)
* stereo (Frame.cc:61): both images extracted batched (the reference's
  two extraction threads become a batch axis), then row-windowed stereo
  descriptor matching with parabolic sub-pixel refinement
  (ComputeStereoMatches, Frame.cc:512-686)

The reference's 64x48 feature grid (AssignFeaturesToGrid) is not needed:
area queries are dense masked distance tests (see ops/matching.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraModel, undistort_pixels
from ..ops import orb
from ..ops.extractor import ExtractorConfig, Features, extract
from ..ops.hamming import hamming_pairwise
from ..ops import pyramid


class Frame(NamedTuple):
    xy: jnp.ndarray        # [N,2] undistorted level-0 pixels
    xy_raw: jnp.ndarray    # [N,2] raw pixels (for drawing)
    ur: jnp.ndarray        # [N] virtual right u (<0 mono / no match)
    depth: jnp.ndarray     # [N] depth (<=0 unknown)
    octave: jnp.ndarray    # [N] i32
    angle: jnp.ndarray     # [N]
    response: jnp.ndarray  # [N]
    desc: jnp.ndarray      # [N,8] u32
    valid: jnp.ndarray     # [N] bool


def make_frame_mono(image, cam: CameraModel, cfg: ExtractorConfig) -> Frame:
    return _make_frame_mono(image, cam, orb.tables(), cfg)


@partial(jax.jit, static_argnums=(3,))
def _make_frame_mono(image, cam: CameraModel, tab: orb.OrbTables,
                     cfg: ExtractorConfig) -> Frame:
    f = extract(image, cfg, tab)
    xy_und = undistort_pixels(cam, f.xy)
    n = f.xy.shape[0]
    return Frame(
        xy=xy_und, xy_raw=f.xy,
        ur=jnp.full((n,), -1.0, jnp.float32),
        depth=jnp.zeros((n,), jnp.float32),
        octave=f.octave, angle=f.angle, response=f.response,
        desc=f.desc, valid=f.valid,
    )


def make_frame_rgbd(image, depth_map, cam: CameraModel,
                    cfg: ExtractorConfig) -> Frame:
    return _make_frame_rgbd(image, depth_map, cam, orb.tables(), cfg)


@partial(jax.jit, static_argnums=(4,))
def _make_frame_rgbd(image, depth_map, cam: CameraModel, tab: orb.OrbTables,
                     cfg: ExtractorConfig) -> Frame:
    """depth_map: [H,W] f32 metric depth (0 = invalid)."""
    f = extract(image, cfg, tab)
    xy_und = undistort_pixels(cam, f.xy)
    h, w = depth_map.shape
    xi = jnp.clip(jnp.round(f.xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(f.xy[:, 1]).astype(jnp.int32), 0, h - 1)
    d = depth_map[yi, xi]
    has_d = d > 0
    ur = jnp.where(has_d, xy_und[:, 0] - cam.bf / jnp.maximum(d, 1e-6), -1.0)
    return Frame(
        xy=xy_und, xy_raw=f.xy, ur=ur,
        depth=jnp.where(has_d, d, 0.0),
        octave=f.octave, angle=f.angle, response=f.response,
        desc=f.desc, valid=f.valid,
    )


def _sad_subpixel_refine(image_l, image_r, xy_l, xy_r, ur0,
                         half: int = 4, slide: int = 4):
    """Refine the right-image x coordinate by sliding-window SAD + parabola
    (ComputeStereoMatches' refinement, Frame.cc:599-655).

    xy_l, xy_r: [N,2] matched keypoint positions; ur0: [N] initial right x.
    Returns refined ur [N].
    """
    h, w = image_l.shape
    win = 2 * half + 1
    yy = jnp.arange(-half, half + 1)
    xx = jnp.arange(-half, half + 1)

    def patch(img, cx, cy):
        xi = jnp.clip(jnp.round(cx).astype(jnp.int32) + xx[None, :], 0, w - 1)
        yi = jnp.clip(jnp.round(cy).astype(jnp.int32) + yy[:, None], 0, h - 1)
        return img[yi, xi]

    def one(cxl, cyl, cxr, cyr):
        pl = patch(image_l, cxl, cyl)  # [win, win]
        # right patches at slide offsets
        offs = jnp.arange(-slide, slide + 1)

        def sad(o):
            pr = patch(image_r, cxr + o.astype(jnp.float32), cyr)
            return jnp.sum(jnp.abs(pl - pr))

        sads = jax.vmap(sad)(offs)  # [2*slide+1]
        j = jnp.argmin(sads)
        jc = jnp.clip(j, 1, 2 * slide - 1)
        s_m, s_0, s_p = sads[jc - 1], sads[jc], sads[jc + 1]
        denom = jnp.maximum(s_m + s_p - 2.0 * s_0, 1e-6)
        delta = jnp.clip(0.5 * (s_m - s_p) / denom, -1.0, 1.0)
        return cxr + offs[jc].astype(jnp.float32) + delta

    return jax.vmap(one)(xy_l[:, 0], xy_l[:, 1], ur0, xy_r[:, 1])


def make_frame_stereo(image_l, image_r, cam: CameraModel,
                      cfg: ExtractorConfig) -> Frame:
    return _make_frame_stereo(image_l, image_r, cam, orb.tables(), cfg)


@partial(jax.jit, static_argnums=(4,))
def _make_frame_stereo(image_l, image_r, cam: CameraModel,
                       tab: orb.OrbTables, cfg: ExtractorConfig) -> Frame:
    """Rectified stereo pair.  Row-banded dense matching:

    For each left keypoint, candidate right keypoints are those within
    +-2 rows (scaled by octave) and disparity in [minD, maxD]; best
    Hamming match below TH wins, then sub-pixel refinement by correlating
    5x5 SAD over an 11-px slide on level images is approximated with a
    parabola over descriptor distances of neighbouring candidates
    (cheaper, validated by ATE).  Reference: Frame.cc:512-686.
    """
    image_l = image_l.astype(jnp.float32)  # u8 uploads: cast on device
    image_r = image_r.astype(jnp.float32)
    fl = extract(image_l, cfg, tab)
    fr = extract(image_r, cfg, tab)
    xy_und = undistort_pixels(cam, fl.xy)  # rectified: dist coeffs ~ 0

    # candidate mask: same row band, positive disparity
    scales = pyramid.level_scales(cfg.n_levels, cfg.scale)
    row_r = 2.0 * scales[fr.octave]  # row tolerance from right kp octave
    dy = jnp.abs(fl.xy[:, 1][:, None] - fr.xy[:, 1][None, :])
    disp = fl.xy[:, 0][:, None] - fr.xy[:, 0][None, :]
    min_d = 0.0
    max_d = cam.bf / jnp.maximum(cam.fx * 0.0 + 1e-6, 1e-6)  # placeholder, see below
    # reference: minD=0, maxD=bf/minZ with minZ=b => maxD = fx
    max_disp = cam.fx
    cand = (
        (dy <= row_r[None, :])
        & (disp >= min_d)
        & (disp <= max_disp)
        & fl.valid[:, None]
        & fr.valid[None, :]
        & (jnp.abs(fl.octave[:, None] - fr.octave[None, :]) <= 1)
    )
    del max_d

    from ..ops import matching as _matching

    d = hamming_pairwise(fl.desc, fr.desc)
    dm = jnp.where(cand, d, 2048)  # sentinel > any real Hamming distance
    best = jnp.argmin(dm, axis=1)
    bestd = jnp.take_along_axis(dm, best[:, None], axis=1)[:, 0]
    # acceptance at the tuned TH_HIGH (reference uses thOrbDist =
    # (TH_HIGH+TH_LOW)/2, Frame.cc:547; our thresholds are re-tuned to
    # this pattern's Hamming statistics in ops/matching.py)
    ok = bestd < (_matching.TH_HIGH + _matching.TH_LOW) // 2

    # sub-pixel disparity by SAD parabola (Frame.cc:599-655): slide a
    # patch window horizontally around the matched right keypoint and fit
    # the SAD minimum.  Integer disparity alone quantizes depth by
    # ~0.5 px, i.e. >10% at far range.
    ur0 = fr.xy[best, 0]
    ur = _sad_subpixel_refine(image_l, image_r, fl.xy, fr.xy[best], ur0)

    disparity = xy_und[:, 0] - ur
    ok &= (disparity > 0.1) & (disparity < max_disp)
    depth = jnp.where(ok, cam.bf / jnp.maximum(disparity, 0.1), 0.0)

    # median-distance outlier rejection (Frame.cc:661-684): drop matches
    # with descriptor distance > 1.5 * 1.4 * median
    med = jnp.median(jnp.where(ok, bestd, jnp.nan).astype(jnp.float32))
    med = jnp.nan_to_num(med, nan=80.0)
    ok &= bestd.astype(jnp.float32) <= 2.1 * med

    return Frame(
        xy=xy_und, xy_raw=fl.xy,
        ur=jnp.where(ok, ur, -1.0),
        depth=jnp.where(ok, depth, 0.0),
        octave=fl.octave, angle=fl.angle, response=fl.response,
        desc=fl.desc, valid=fl.valid,
    )
