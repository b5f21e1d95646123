"""Oriented binary descriptors: IC-angle orientation + rotated BRIEF.

Replaces reference ORBextractor's IC_Angle (ORBextractor.cc:78-106) and
computeOrbDescriptor (ORBextractor.cc:111-152).

Design difference from the reference (deliberate): the reference
hardcodes OpenCV's learned 256-pair sampling table (bit_pattern_31_,
ORBextractor.cc:155-413).  We instead generate our own deterministic
BRIEF-style pattern (seeded Gaussian pairs, original BRIEF G-II scheme,
decorrelated by greedy selection at import time).  Descriptors are
therefore NOT bit-compatible with OpenCV ORB — matching quality is
validated at the trajectory-ATE level instead (see SURVEY.md §7 "hard
parts": bit-exactness vs OpenCV is impossible anyway).

All sampling is expressed as one big gather per level: [N, 512] pixel
fetches from the blurred level image, then bit packing to [N, DESC_WORDS] uint32.

The sampling tables are kept as NUMPY module constants and shipped to
the device ONCE via `tables()`, then passed to every jitted function as
ARGUMENTS rather than captured as closure constants, so a program never
embeds the large tables and one upload serves every call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

HALF_PATCH = 15  # orientation patch radius (reference ORBextractor.cc:74)
PATTERN_RADIUS = 13  # BRIEF sample points stay within this radius
N_BITS = 512  # 2x the reference's 256 (ORBextractor.cc
# bit_pattern_31_): the extra bits buy matched-vs-random margin that
# 256-bit BRIEF lacks on low-distinctiveness texture (fuse/loop
# regressions on the synthetic scenes)
DESC_WORDS = N_BITS // 32


def _make_pattern(seed: int = 17) -> np.ndarray:
    """Generate a decorrelated 256-pair sampling pattern, [256, 4] int32
    (py, px, qy, qx).

    BRIEF G-II: both endpoints ~ N(0, (S/5)^2) clipped to the patch.  A
    greedy pass keeps candidate pairs whose endpoints are not too close to
    an already chosen pair, which decorrelates neighbouring bits cheaply.
    """
    rng = np.random.RandomState(seed)
    sigma = 31 / 5.0
    chosen: list[tuple[int, int, int, int]] = []
    seen = set()
    while len(chosen) < N_BITS:
        cand = np.clip(
            np.round(rng.randn(4) * sigma), -PATTERN_RADIUS, PATTERN_RADIUS
        ).astype(np.int32)
        py, px, qy, qx = (int(v) for v in cand)
        if (py, px) == (qy, qx):
            continue
        key = (py, px, qy, qx)
        if key in seen or (qy, qx, py, px) in seen:
            continue
        seen.add(key)
        chosen.append(key)
    return np.asarray(chosen, np.int32)


def _load_pattern() -> np.ndarray:
    """Learned pattern if present (see pattern_train.py), else seeded random."""
    import os

    path = os.path.join(os.path.dirname(__file__), "brief_pattern.npy")
    if os.path.exists(path):
        pat = np.load(path)
        if pat.shape == (N_BITS, 4):
            return pat.astype(np.int32)
    return _make_pattern()


PATTERN = _load_pattern()  # [256, 4] numpy (device copy lives in tables())


def _circular_umax() -> np.ndarray:
    """Per-row half-width of the radius-15 circular patch (ref u_max,
    ORBextractor.cc:434-446 semantics: symmetric circle)."""
    v = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return np.floor(np.sqrt(np.maximum(HALF_PATCH**2 - v**2, 0)) + 0.5).astype(np.int32)


_UMAX = _circular_umax()
# Precompute the circular orientation mask and coordinate grids once.
# NUMPY on purpose (see module docstring): device copies live in tables().
_Y, _X = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
CIRC_MASK = (np.abs(_X) <= _UMAX[_Y + HALF_PATCH]).astype(np.float32)
GRID_X = _X.astype(np.float32) * CIRC_MASK
GRID_Y = _Y.astype(np.float32) * CIRC_MASK


class OrbTables(NamedTuple):
    """Device-resident sampling tables, passed into jitted kernels as
    arguments (NOT captured — see module docstring)."""

    grid_x: jnp.ndarray       # [31,31] f32 x-moment weights
    grid_y: jnp.ndarray       # [31,31] f32 y-moment weights
    circ_mask: jnp.ndarray    # [31,31] f32 circular patch mask
    rot_offsets: jnp.ndarray  # [B,2*N_BITS,2] i32 steered BRIEF offsets
    brief_diff: jnp.ndarray   # [B,37*37,N_BITS] f32 +-1 diff matmul


_TABLES: OrbTables | None = None


def tables() -> OrbTables:
    """The device copy of the sampling tables (uploaded once per process).
    Call OUTSIDE jit and pass the result through jit boundaries."""
    global _TABLES
    if _TABLES is None:
        _TABLES = OrbTables(
            grid_x=jnp.asarray(GRID_X),
            grid_y=jnp.asarray(GRID_Y),
            circ_mask=jnp.asarray(CIRC_MASK),
            rot_offsets=jnp.asarray(_rotated_offset_table()),
            brief_diff=jnp.asarray(_brief_diff_table()),
        )
    return _TABLES


def ic_angles(image: jnp.ndarray, kps: jnp.ndarray, valid: jnp.ndarray,
              tab: OrbTables | None = None):
    """Intensity-centroid angle per keypoint.

    image: [H, W] f32 level image (unblurred, like the reference).
    kps:   [N, 2] f32 (x, y) level coordinates.
    tab:   sampling tables; REQUIRED when called inside jit (default only
           resolves safely outside a trace).
    Returns angles [N] in radians.
    """
    if tab is None:
        tab = tables()
    GRID_Xd, GRID_Yd, CIRC_MASKd = tab.grid_x, tab.grid_y, tab.circ_mask
    h, w = image.shape
    x0 = jnp.clip(jnp.round(kps[:, 0]).astype(jnp.int32), HALF_PATCH, w - HALF_PATCH - 1)
    y0 = jnp.clip(jnp.round(kps[:, 1]).astype(jnp.int32), HALF_PATCH, h - HALF_PATCH - 1)

    def patch_moments(xc, yc):
        p = jax.lax.dynamic_slice(
            image, (yc - HALF_PATCH, xc - HALF_PATCH), (2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1)
        )
        m10 = jnp.sum(p * GRID_Xd)
        m01 = jnp.sum(p * GRID_Yd)
        n = jnp.sum(CIRC_MASKd)
        mu = jnp.sum(p * CIRC_MASKd) / n
        var = jnp.sum((p - mu) ** 2 * CIRC_MASKd) / n
        return m10, m01, var

    m10, m01, var = jax.vmap(patch_moments)(x0, y0)
    # degenerate-orientation guard: for (near) radially symmetric patches
    # the centroid direction is pure noise and the steered pattern would
    # scramble between views — snap those to angle 0.  (The reference has
    # no such guard, IC_Angle ORBextractor.cc:78.)  Significance scale:
    # |m| for an uninformative patch ~ sigma_patch * sqrt(sum r^2).
    mag2 = m10 * m10 + m01 * m01
    sum_r2 = float(np.sum(GRID_X**2 + GRID_Y**2))  # numpy: compile-time scalar
    strong = mag2 > 4.0 * var * sum_r2
    return jnp.where(valid & strong, jnp.arctan2(m01, m10), 0.0)


N_ANGLE_BINS = 32  # steering-angle quantization (OpenCV ORB uses 30 x 12deg)


def _rotated_offset_table() -> np.ndarray:
    """Precomputed nearest-pixel rotated pattern offsets, [B, 2*N_BITS, 2] (dy, dx).

    The reference steers the pattern with the exact angle but rounds each
    sample to the nearest pixel (computeOrbDescriptor, ORBextractor.cc:111
    GET_VALUE cvRound); OpenCV ORB additionally quantizes the angle itself
    to 12-degree bins.  Quantizing to B=32 bins lets the whole steering be
    a static table so descriptor sampling is ONE gather instead of eight.
    """
    pat = _load_pattern().astype(np.float64)  # [N_BITS, 4] (py, px, qy, qx)
    pts = np.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0)  # [2*N_BITS] (y, x)
    out = np.zeros((N_ANGLE_BINS, 2 * N_BITS, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        ry = sa * pts[:, 1] + ca * pts[:, 0]
        rx = ca * pts[:, 1] - sa * pts[:, 0]
        out[b, :, 0] = np.round(ry)
        out[b, :, 1] = np.round(rx)
    return out


ROT_OFFSETS = _rotated_offset_table()  # [B, 2*N_BITS, 2] numpy (device: tables())


BRIEF_HALF = int(np.abs(ROT_OFFSETS).max())  # rotated corner reach (18)


def _brief_diff_table() -> np.ndarray:
    """[B, 961, N_BITS] f32 sparse +-1 difference operators: for angle
    bin b and bit k, column k has +1 at the rotated q sample and -1 at
    the rotated p sample (bit = p < q  <=>  patch . D > 0).

    Lets steered-BRIEF sampling run as ONE matmul per frame (~16 GMAC
    for 1024 keypoints) instead of a per-keypoint scattered gather
    (take_along_axis over [N, 961] patches).  Which form is faster on
    the H100 is not measured."""
    side = 2 * BRIEF_HALF + 1
    D = np.zeros((N_ANGLE_BINS, side * side, N_BITS), np.float32)
    off = ROT_OFFSETS
    for b in range(N_ANGLE_BINS):
        lin_p = (off[b, :N_BITS, 0] + BRIEF_HALF) * side + \
            off[b, :N_BITS, 1] + BRIEF_HALF
        lin_q = (off[b, N_BITS:, 0] + BRIEF_HALF) * side + \
            off[b, N_BITS:, 1] + BRIEF_HALF
        D[b, lin_p, np.arange(N_BITS)] += -1.0
        D[b, lin_q, np.arange(N_BITS)] += 1.0
    return D


def brief_descriptors(blurred: jnp.ndarray, kps: jnp.ndarray, angles: jnp.ndarray,
                      valid: jnp.ndarray, tab: OrbTables | None = None) -> jnp.ndarray:
    """Rotated-BRIEF descriptors, bit-packed.

    blurred: [H, W] f32 blurred level image.
    kps: [N,2] (x,y) level coords; angles [N] radians.
    tab: sampling tables; REQUIRED when called inside jit.
    Returns [N, DESC_WORDS] uint32 (N_BITS bits).
    """
    if tab is None:
        tab = tables()
    h, w = blurred.shape
    two_pi = 2.0 * jnp.pi
    bin_ = jnp.round(
        (angles % two_pi) / (two_pi / N_ANGLE_BINS)
    ).astype(jnp.int32) % N_ANGLE_BINS
    off = tab.rot_offsets[bin_]                      # [N, 2*N_BITS, 2]

    yk = jnp.round(kps[:, 1]).astype(jnp.int32)[:, None]
    xk = jnp.round(kps[:, 0]).astype(jnp.int32)[:, None]
    yy = jnp.clip(yk + off[..., 0], 0, h - 1)
    xx = jnp.clip(xk + off[..., 1], 0, w - 1)
    vals = jnp.take(blurred.reshape(-1), yy * w + xx)  # [N, 2*N_BITS]
    bits = (vals[:, :N_BITS] < vals[:, N_BITS:]).astype(jnp.uint32)

    # pack into uint32 words, little-endian bit order within each word
    words = bits.reshape(bits.shape[0], DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
    return jnp.where(valid[:, None], packed, 0)


def keypoint_patches(pyr3d: jnp.ndarray, kps: jnp.ndarray,
                     octave: jnp.ndarray, level_hw: tuple,
                     half: int = HALF_PATCH):
    """[N, 31, 31] patches around per-level keypoints from a PADDED 3-D
    pyramid [L, H0, W0] — one vmapped dynamic_slice whose per-row reads
    stay contiguous (a flattened-pyramid linear gather loses the row
    structure)."""
    hs = jnp.asarray([d[0] for d in level_hw], jnp.int32)[octave]
    ws = jnp.asarray([d[1] for d in level_hw], jnp.int32)[octave]
    x0 = jnp.clip(jnp.round(kps[:, 0]).astype(jnp.int32),
                  half, ws - half - 1)
    y0 = jnp.clip(jnp.round(kps[:, 1]).astype(jnp.int32),
                  half, hs - half - 1)

    def one(o, y, x):
        return jax.lax.dynamic_slice(
            pyr3d, (o, y - half, x - half),
            (1, 2 * half + 1, 2 * half + 1))[0]

    return jax.vmap(one)(octave, y0, x0)


def ic_angles_patches(patches: jnp.ndarray, valid: jnp.ndarray,
                      tab: OrbTables) -> jnp.ndarray:
    """IC angles from prefetched [N, 31, 31] patches (all levels at
    once; see keypoint_patches)."""
    p = patches.reshape(patches.shape[0], -1)          # [N, 961]
    gx = tab.grid_x.reshape(-1)[None, :]
    gy = tab.grid_y.reshape(-1)[None, :]
    cm = tab.circ_mask.reshape(-1)[None, :]
    m10 = jnp.sum(p * gx, axis=1)
    m01 = jnp.sum(p * gy, axis=1)
    n = jnp.sum(cm)
    mu = jnp.sum(p * cm, axis=1) / n
    var = jnp.sum((p - mu[:, None]) ** 2 * cm, axis=1) / n
    mag2 = m10 * m10 + m01 * m01
    sum_r2 = float(np.sum(GRID_X**2 + GRID_Y**2))
    strong = mag2 > 4.0 * var * sum_r2
    return jnp.where(valid & strong, jnp.arctan2(m01, m10), 0.0)


def brief_descriptors_patches(patches_blur: jnp.ndarray,
                              angles: jnp.ndarray, valid: jnp.ndarray,
                              tab: OrbTables) -> jnp.ndarray:
    """Rotated BRIEF from prefetched [N, 31, 31] BLURRED patches as one
    matmul: bit k = sign(patch . D_bin[:, k]) with D the per-bin +-1
    difference table (_brief_diff_table).  HIGHEST precision is
    load-bearing: reduced-precision passes (bf16, TF32) flip bits where
    |p - q| is within rounding noise, and flipped bits cost mono accuracy
    (scale drift amplifies descriptor noise); exact f32 reproduces the
    gather formulation bit-for-bit."""
    N = patches_blur.shape[0]
    side = patches_blur.shape[1]
    flat = patches_blur.reshape(N, side * side)
    two_pi = 2.0 * jnp.pi
    bin_ = jnp.round(
        (angles % two_pi) / (two_pi / N_ANGLE_BINS)
    ).astype(jnp.int32) % N_ANGLE_BINS
    diffs = jnp.einsum("np,bpk->bnk", flat, tab.brief_diff,
                       precision=jax.lax.Precision.HIGHEST)  # [B,N,512]
    sel = jnp.take_along_axis(
        diffs, bin_[None, :, None], axis=0)[0]         # [N, N_BITS]
    bits = (sel > 0).astype(jnp.uint32)
    words = bits.reshape(N, DESC_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    packed = jnp.sum(words << shifts[None, None, :], axis=-1,
                     dtype=jnp.uint32)
    return jnp.where(valid[:, None], packed, 0)
