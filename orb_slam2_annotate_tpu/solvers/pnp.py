"""Batched PnP RANSAC for relocalization.

Replaces PnPsolver.cc (vendored EPnP + P4P RANSAC, Lepetit et al.).
Batch-first redesign: instead of EPnP's control-point/beta machinery run
sequentially per hypothesis, ALL RANSAC hypotheses are solved at once
with a vmapped 6-point DLT (linear PnP): each hypothesis builds the
2n x 12 projection system, takes its SVD null vector as [R|t] up to
scale, orthonormalizes R by SVD projection, fixes scale/sign by
cheirality, and scores inliers against all correspondences as one
[S, N] reprojection matrix.  The winner is then polished with the
motion-only LM optimizer (optimize_pose), which plays the role of the
reference's iterative refinement (PnPsolver::Refine + the caller's
PoseOptimization, Tracking.cc:1529).

RANSAC parameters follow Tracking.cc:1507: 300 iterations max, chi2
threshold 5.991 sigma^2, min inliers per model accepted by the caller.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from ..geometry.camera import CameraModel
from . import pose_opt


class PnPResult(NamedTuple):
    success: jnp.ndarray   # bool
    R: jnp.ndarray         # [3,3]
    t: jnp.ndarray         # [3]
    inliers: jnp.ndarray   # [N] bool
    n_inliers: jnp.ndarray # i32


def _dlt_pnp(xw: jnp.ndarray, xn: jnp.ndarray):
    """Linear PnP from 6 points: world [6,3] -> normalized cam coords [6,2].

    Returns (R [3,3], t [3]).  Solves P = [R|t] up to scale from
    x ~ P X with the standard DLT, then projects onto SO(3).
    """
    X = jnp.concatenate([xw, jnp.ones((6, 1), xw.dtype)], axis=1)  # [6,4]
    z = jnp.zeros((6, 4), xw.dtype)
    u = xn[:, 0:1]
    v = xn[:, 1:2]
    r1 = jnp.concatenate([X, z, -u * X], axis=1)       # [6,12]
    r2 = jnp.concatenate([z, X, -v * X], axis=1)       # [6,12]
    A = jnp.concatenate([r1, r2, jnp.zeros((1, 12), xw.dtype)], axis=0)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    P = Vt[-1].reshape(3, 4)
    M = P[:, :3]
    # scale: |det| -> 1, sign by cheirality of the centroid
    det = jnp.linalg.det(M)
    s = jnp.sign(det) * jnp.abs(det) ** (1.0 / 3.0)
    s = jnp.where(jnp.abs(s) < 1e-12, 1e-12, s)
    M = M / s
    t = P[:, 3] / s
    # project M onto SO(3)
    U, _, Vt2 = jnp.linalg.svd(M)
    R = U @ Vt2
    R = R * jnp.sign(jnp.linalg.det(R))
    # recompute t with the orthonormal R by aligning projections of centroid
    return R, t


@partial(jax.jit, static_argnums=(5,))
def pnp_ransac(key, cam: CameraModel, xw: jnp.ndarray, uv: jnp.ndarray,
               valid: jnp.ndarray, n_hyp: int = 256,
               chi2_th: float = 5.991, min_inliers: int = 10) -> PnPResult:
    """xw [N,3] world points, uv [N,2] undistorted pixels, valid [N]."""
    N = xw.shape[0]
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], axis=1
    )

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    keys = jax.random.split(key, n_hyp)
    samples = jax.vmap(
        lambda k: jax.random.choice(k, N, (6,), replace=False, p=probs)
    )(keys)  # [S, 6]

    Rs, ts = jax.vmap(lambda s: _dlt_pnp(xw[s], xn[s]))(samples)

    # score all hypotheses: [S, N] chi2
    def score(R, t):
        xc = xw @ R.T + t
        zok = xc[:, 2] > 1e-3
        z = jnp.where(zok, xc[:, 2], 1.0)
        u = cam.fx * xc[:, 0] / z + cam.cx
        v = cam.fy * xc[:, 1] / z + cam.cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inl = valid & zok & (e2 < chi2_th * 4.0)
        return jnp.sum(inl), inl

    ns, inls = jax.vmap(score)(Rs, ts)
    best = jnp.argmax(ns)
    R0, t0 = Rs[best], ts[best]

    # polish with robust LM on all points (inliers re-decided inside)
    obs = pose_opt.PoseObs(
        xw=xw, uv=uv, ur=jnp.full((N,), -1.0, jnp.float32),
        inv_sigma2=jnp.ones((N,), jnp.float32), valid=valid,
    )
    R, t, inl, n = pose_opt.optimize_pose(cam, R0, t0, obs)
    ok = (ns[best] >= min_inliers) & (n >= min_inliers)
    return PnPResult(ok, R, t, inl, n)
