"""End-to-end ORB feature extraction for one frame.

The counterpart of ORBextractor::operator() (ORBextractor.cc:1119-1196):
pyramid -> whole-level FAST -> NMS -> per-cell selection -> IC orientation
-> blur -> rotated BRIEF -> rescale coordinates to level 0.  Everything is
one jitted program per image size; all outputs have static shapes with a
validity mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import fast, orb, pyramid, select


class ExtractorConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    th_fast_hi: float = 20.0
    th_fast_lo: float = 7.0
    # margin keeps orientation/descriptor patches inside each level
    # (reference EDGE_THRESHOLD = 19, ORBextractor.cc:75)
    margin: int = 19


class Features(NamedTuple):
    """Per-frame extracted features, fixed capacity N = n_features.

    xy:      [N, 2] f32 level-0 (raw, distorted) pixel coordinates
    response:[N]   f32 FAST score
    octave:  [N]   i32 pyramid level
    angle:   [N]   f32 radians
    desc:    [N, 8] u32 bit-packed 256-bit descriptors
    valid:   [N]   bool
    """

    xy: jnp.ndarray
    response: jnp.ndarray
    octave: jnp.ndarray
    angle: jnp.ndarray
    desc: jnp.ndarray
    valid: jnp.ndarray

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def _select_level(img, budget, cfg: ExtractorConfig, level: int):
    # plain XLA: these memory-bound stencils fuse into few passes, and
    # the ragged pyramid level shapes suit no fixed kernel tiling
    score, is_hi = fast.fast_score_map(img, cfg.th_fast_lo, cfg.th_fast_hi)
    score = fast.nms3x3(score)
    # mask out the EDGE margin so patches stay inside
    h, w = img.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    m = cfg.margin
    ok = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    score = jnp.where(ok, score, 0.0)

    xy, resp, valid = select.select_keypoints(score, is_hi, budget)
    octave = jnp.full((budget,), level, jnp.int32)
    return xy, resp, octave, valid


def extract(image: jnp.ndarray, cfg: ExtractorConfig = ExtractorConfig(),
            tab: orb.OrbTables | None = None) -> Features:
    """image: [H, W] grayscale in [0, 255] (u8 or f32).  Returns Features.

    Accepting uint8 lets callers ship 1 byte/pixel host-to-device (4x
    less than f32); the cast to f32 happens on device.

    When called OUTSIDE jit, the sampling tables resolve automatically;
    inside a jitted caller, pass `tab` through from the host (see
    ops/orb.py: tables are arguments, never captured constants).
    """
    if tab is None:
        if isinstance(image, jax.core.Tracer):
            raise ValueError(
                "extract() called inside jit without `tab`: pass "
                "orb.tables() through the jit boundary."
            )
        tab = orb.tables()
    return _extract_jit(image, tab, cfg)


@functools.partial(jax.jit, static_argnums=(2,))
def _extract_jit(image: jnp.ndarray, tab: orb.OrbTables,
                 cfg: ExtractorConfig) -> Features:
    image = image.astype(jnp.float32)
    levels = pyramid.build_pyramid(image, cfg.n_levels, cfg.scale)
    budgets = pyramid.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale)
    scales = [cfg.scale**l for l in range(cfg.n_levels)]

    # per-level corner detection + selection (dense stencils, cheap)
    parts = []
    for l, (img, budget) in enumerate(zip(levels, budgets)):
        parts.append(_select_level(img, budget, cfg, l))
    cat = lambda i: jnp.concatenate([p[i] for p in parts], axis=0)
    xy_l = cat(0)           # LEVEL coordinates (orientation/descriptor)
    resp, octv, valid = cat(1), cat(2), cat(3)

    # orientation + descriptors for ALL levels at once: prefetch one
    # [N, 31, 31] patch per keypoint from a padded 3-D pyramid (row-
    # contiguous slices), then IC / steered-BRIEF read only patches
    # (one batch for all levels instead of one vmapped batch per level)
    H0, W0 = levels[0].shape
    level_hw = tuple(img.shape for img in levels)
    pad3 = lambda ims: jnp.stack(
        [jnp.pad(im, ((0, H0 - im.shape[0]), (0, W0 - im.shape[1])))
         for im in ims])
    pyr3 = pad3(levels)
    pyr3_blur = pad3([pyramid.gaussian_blur(img) for img in levels])
    patches = orb.keypoint_patches(pyr3, xy_l, octv, level_hw)
    patches_b = orb.keypoint_patches(pyr3_blur, xy_l, octv, level_hw,
                                     half=orb.BRIEF_HALF)
    ang = orb.ic_angles_patches(patches, valid, tab)
    desc = orb.brief_descriptors_patches(patches_b, ang, valid, tab)

    # rescale to level-0 coords (ORBextractor.cc:1186-1195)
    scale_per = jnp.asarray(scales, jnp.float32)[octv]
    feats = Features(xy_l * scale_per[:, None], resp, octv, ang, desc,
                     valid)
    # pad to exactly n_features if the per-level budgets rounded short
    n = feats.xy.shape[0]
    if n < cfg.n_features:
        pad = cfg.n_features - n
        feats = Features(
            jnp.concatenate([feats.xy, jnp.zeros((pad, 2), jnp.float32)]),
            jnp.concatenate([feats.response, jnp.zeros((pad,), jnp.float32)]),
            jnp.concatenate([feats.octave, jnp.zeros((pad,), jnp.int32)]),
            jnp.concatenate([feats.angle, jnp.zeros((pad,), jnp.float32)]),
            jnp.concatenate([feats.desc, jnp.zeros((pad, orb.DESC_WORDS), jnp.uint32)]),
            jnp.concatenate([feats.valid, jnp.zeros((pad,), bool)]),
        )
    elif n > cfg.n_features:
        feats = Features(*(a[: cfg.n_features] for a in feats))
    return feats
