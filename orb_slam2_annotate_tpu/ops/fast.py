"""Vectorized FAST-9/16 corner detection with dual-threshold fallback.

Replaces reference ORBextractor::ComputeKeyPointsOctTree's per-cell
cv::FAST calls (ORBextractor.cc:815-896).  Instead of looping over 30x30
cells on the host, the whole level is evaluated as one fused array program
(16 shifted comparisons + circular-arc reduction) — elementwise work — and
the reference's "threshold 20, retry 7" per-cell logic becomes a single
pass at the low threshold with a per-pixel flag for "also passes the high
threshold", resolved during per-cell selection (see select.py).

The corner test is the standard segment test: >= 9 contiguous pixels on the
16-pixel Bresenham circle all brighter than center+t or all darker than
center-t.  Score is the FAST "V" value: max over the two polarities of the
sum of absolute exceedances over the qualifying arc's pixels.
"""

from __future__ import annotations

import jax.numpy as jnp

# 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock,
# as (dy, dx) offsets — the standard FAST circle.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9


def _shifted(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """img shifted so out[y, x] = img[y+dy, x+dx], zero-padded at borders.

    Border pixels are excluded by the caller's margin mask, so padding value
    is irrelevant.
    """
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


def fast_score_map(img: jnp.ndarray, threshold_lo: float, threshold_hi: float):
    """Compute FAST responses for a whole level.

    img: [H, W] float32 grayscale (0..255 scale).
    Returns (score [H,W] f32, is_hi [H,W] bool): score > 0 where the pixel
    passes the segment test at threshold_lo; is_hi marks pixels that also
    pass at threshold_hi.  Borders (3 px) are zeroed.
    """
    h, w = img.shape
    ring = jnp.stack([_shifted(img, dy, dx) for dy, dx in CIRCLE])  # [16,H,W]
    diff = ring - img[None]

    # "V" score à la OpenCV cornerScore: the largest threshold at which the
    # segment test still passes = max over the 16 arc starts of the min
    # exceedance along the arc.  Corner test at threshold t is then simply
    # score > t, and NMS ranks identically to cv2.FAST.
    def arc_strength(d):
        # d: [16, H, W] signed exceedance for one polarity (positive = good)
        best = jnp.full(img.shape, -jnp.inf, img.dtype)
        for start in range(16):
            run = d[start]
            for i in range(1, ARC_LEN):
                run = jnp.minimum(run, d[(start + i) % 16])
            best = jnp.maximum(best, run)
        return best  # max-min exceedance; > t  <=>  corner at threshold t

    v_bright = arc_strength(diff)
    v_dark = arc_strength(-diff)
    score_lo = jnp.maximum(v_bright, v_dark)
    is_lo = score_lo > threshold_lo
    is_hi = score_lo > threshold_hi

    # zero out the 3-px border (roll wraps around)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    score = jnp.where(is_lo & interior, score_lo, 0.0)
    return score, is_hi & interior


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression: keep score only at local maxima."""
    neigh = [
        jnp.roll(score, (dy, dx), (0, 1))
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if not (dy == 0 and dx == 0)
    ]
    m = score
    for n in neigh:
        m = jnp.maximum(m, n)
    return jnp.where(score >= m, score, 0.0)
