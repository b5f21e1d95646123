"""Spatially-uniform keypoint selection (octree replacement).

Replaces reference ORBextractor::DistributeOctTree (ORBextractor.cc:566),
a divergent host-side recursion, with a data-parallel two-stage selection:

1. per-cell top-1: the NMS'd score map is reshaped into a grid of cells
   (cell count ~= 2x the level budget) and each cell keeps its best corner,
   preferring corners that pass the high FAST threshold (this reproduces
   the reference's per-cell "threshold 20, retry with 7" behaviour,
   ORBextractor.cc:815-896).
2. global top-n over cell winners by (hi-threshold flag, score).

This yields the same qualitative property the octree provides — at most
one corner per spatial cell, strongest first — with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# priority bonus ensuring hi-threshold corners always beat lo-only corners
_HI_BONUS = 1e6


def _pick_cell_size(h: int, w: int, budget: int) -> int:
    """Largest cell size whose grid has >= 2*budget cells (min 8 px)."""
    cs = 64
    while cs > 8 and (h // cs) * (w // cs) < 2 * budget:
        cs //= 2
    return max(cs, 8)


def select_keypoints(score: jnp.ndarray, is_hi: jnp.ndarray, budget: int,
                     cell_size: int | None = None):
    """Select up to `budget` spatially-spread keypoints from a score map.

    score: [H, W] f32, zero at non-corners (already NMS'd).
    is_hi: [H, W] bool, passes the high threshold.
    Returns (xy [budget, 2] f32, resp [budget] f32, valid [budget] bool).
    """
    h, w = score.shape
    cs = cell_size or _pick_cell_size(h, w, budget)
    gh, gw = h // cs, w // cs
    # crop to a multiple of the cell size (borders are margin anyway)
    s = score[: gh * cs, : gw * cs].reshape(gh, cs, gw, cs).transpose(0, 2, 1, 3)
    s = s.reshape(gh * gw, cs * cs)
    hi = is_hi[: gh * cs, : gw * cs].reshape(gh, cs, gw, cs).transpose(0, 2, 1, 3)
    hi = hi.reshape(gh * gw, cs * cs)

    prio = s + jnp.where(hi, _HI_BONUS, 0.0)
    prio = jnp.where(s > 0, prio, -1.0)
    best = jnp.argmax(prio, axis=1)  # [cells]
    cell_prio = jnp.take_along_axis(prio, best[:, None], axis=1)[:, 0]
    cell_score = jnp.take_along_axis(s, best[:, None], axis=1)[:, 0]

    n_cells = gh * gw
    k = min(budget, n_cells)
    vals, cells = jax.lax.top_k(cell_prio, k)
    sel_best = best[cells]
    cy = cells // gw
    cx = cells % gw
    py = sel_best // cs
    px = sel_best % cs
    x = (cx * cs + px).astype(jnp.float32)
    y = (cy * cs + py).astype(jnp.float32)
    xy = jnp.stack([x, y], axis=1)
    resp = cell_score[cells]
    valid = vals > 0

    if k < budget:
        pad = budget - k
        xy = jnp.concatenate([xy, jnp.zeros((pad, 2), jnp.float32)])
        resp = jnp.concatenate([resp, jnp.zeros((pad,), jnp.float32)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    return xy, resp, valid
