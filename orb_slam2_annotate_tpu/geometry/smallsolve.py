"""Closed-form small-matrix solves for hot loops.

jnp.linalg.solve / jax.scipy.linalg.solve lower to pivoted LU /
blocked Cholesky — sequential scalar-heavy algorithms that dominate the
latency of LM iterations when the system is only 3x3 or 6x6 (pose
optimization solves a 6x6 40+ times per frame).  These helpers are pure
closed-form arithmetic: a handful of fused elementwise ops, fully batchable,
with no data-dependent control flow.

Used by solvers/pose_opt.py (6x6 damped LM step) and geometry/lie.py
(3x3 left-Jacobian solve in se3_log).  Citation for the semantics they
replace: g2o's LinearSolverDense in PoseOptimization (Optimizer.cc:258).
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) inverse of [..., 3, 3] matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    det_safe = jnp.where(jnp.abs(det) < 1e-20,
                         jnp.where(det < 0, -1e-20, 1e-20), det)
    inv = jnp.stack([
        jnp.stack([co00, co01, co02], axis=-1),
        jnp.stack([co10, co11, co12], axis=-1),
        jnp.stack([co20, co21, co22], axis=-1),
    ], axis=-2)
    return inv / det_safe[..., None, None]


def solve3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve [..., 3, 3] @ x = [..., 3] in closed form."""
    return jnp.einsum("...ij,...j->...i", inv3(A), b)


def solve6_spd(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Solve a symmetric positive-definite [..., 6, 6] system via 3x3
    block Schur complement:

      [A B; B^T D] [x; y] = [u; v]
      S = D - B^T A^-1 B;  y = S^-1 (v - B^T A^-1 u);  x = A^-1 (u - B y)

    Two adjugate 3x3 inverses + four 3x3 matmuls — all closed-form.
    """
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    u = g[..., :3]
    v = g[..., 3:]
    Ai = inv3(A)
    AiB = Ai @ B                                     # [...,3,3]
    S = D - jnp.swapaxes(B, -1, -2) @ AiB
    Si = inv3(S)
    Aiu = jnp.einsum("...ij,...j->...i", Ai, u)
    rhs = v - jnp.einsum("...ji,...j->...i", AiB, u)  # v - B^T A^-1 u
    y = jnp.einsum("...ij,...j->...i", Si, rhs)
    x = Aiu - jnp.einsum("...ij,...j->...i", AiB, y)
    return jnp.concatenate([x, y], axis=-1)
