"""Sim(3) estimation between keyframes for loop closing.

Replaces Sim3Solver.cc: Horn's closed-form absolute orientation
(quaternion eigendecomposition, ComputeCentroid:232 / ComputeSim3:240)
inside a RANSAC loop (iterate:150).  Batch-first: all RANSAC hypotheses are
solved at once — [S, 3] point triples -> vmapped 4x4 symmetric
eigendecompositions -> [S, N] reprojection scoring in both directions.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraModel


def horn_sim3(x1: jnp.ndarray, x2: jnp.ndarray, w: jnp.ndarray,
              fix_scale: bool = False):
    """Closed-form Sim3 (s, R, t) with x2 ~ s R x1 + t (weighted Horn).

    x1, x2: [N, 3]; w: [N] weights.  Horn 1987 quaternion method.
    """
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    c1 = jnp.sum(x1 * w[:, None], axis=0) / wsum
    c2 = jnp.sum(x2 * w[:, None], axis=0) / wsum
    a = x1 - c1
    b = x2 - c2
    M = jnp.einsum("ni,nj,n->ij", a, b, w)  # sum a b^T

    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    Q = jnp.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    vals, vecs = jnp.linalg.eigh(Q)
    q = vecs[:, -1]  # [w, x, y, z]
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    R = jnp.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )
    Ra = a @ R.T
    num = jnp.sum(Ra * b * w[:, None])
    den = jnp.maximum(jnp.sum(Ra * Ra * w[:, None]), 1e-12)
    s = jnp.where(fix_scale, 1.0, num / den)
    t = c2 - s * (R @ c1)
    return s, R, t


class Sim3Result(NamedTuple):
    success: jnp.ndarray
    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnums=(6, 7))
def sim3_ransac(key, cam: CameraModel, x1, x2, uv1, uv2,
                n_hyp: int = 128, fix_scale: bool = False,
                valid=None, th_chi2: float = 9.21,
                inv_sigma2_1=None, inv_sigma2_2=None,
                min_inliers: int = 20) -> Sim3Result:
    """RANSAC Sim3 from matched 3D point pairs with image-space scoring.

    x1, x2: [N,3] matched map points in the two keyframes' CAMERA frames
    (like the reference, Sim3Solver.cc:66-99).  uv1, uv2: their observed
    pixels.  Scoring projects x2 through S12^-1 into image 1 and x1
    through S12 into image 2 (CheckInliers, Sim3Solver.cc:224).
    th_chi2 = 9.21 (Sim3Solver.cc:86 mTh ~ chi2 99% 2dof).
    """
    N = x1.shape[0]
    if valid is None:
        valid = jnp.ones((N,), bool)
    if inv_sigma2_1 is None:
        inv_sigma2_1 = jnp.ones((N,))
    if inv_sigma2_2 is None:
        inv_sigma2_2 = jnp.ones((N,))

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    keys = jax.random.split(key, n_hyp)
    samples = jax.vmap(
        lambda k: jax.random.choice(k, N, (3,), replace=False, p=probs)
    )(keys)

    def fit(sample):
        w3 = jnp.ones((3,))
        return horn_sim3(x1[sample], x2[sample], w3, fix_scale)

    ss, Rs, ts = jax.vmap(fit)(samples)

    def score(s, R, t):
        # x1 -> frame 2
        y2 = s * (x1 @ R.T) + t
        u2 = jnp.stack(
            [cam.fx * y2[:, 0] / jnp.maximum(y2[:, 2], 1e-6) + cam.cx,
             cam.fy * y2[:, 1] / jnp.maximum(y2[:, 2], 1e-6) + cam.cy], 1
        )
        e2 = jnp.sum((u2 - uv2) ** 2, 1) * inv_sigma2_2
        # x2 -> frame 1 (inverse)
        si = 1.0 / s
        Ri = R.T
        ti = -si * (Ri @ t)
        y1 = si * (x2 @ Ri.T) + ti
        u1 = jnp.stack(
            [cam.fx * y1[:, 0] / jnp.maximum(y1[:, 2], 1e-6) + cam.cx,
             cam.fy * y1[:, 1] / jnp.maximum(y1[:, 2], 1e-6) + cam.cy], 1
        )
        e1 = jnp.sum((u1 - uv1) ** 2, 1) * inv_sigma2_1
        inl = valid & (e1 < th_chi2) & (e2 < th_chi2) & (y1[:, 2] > 0) & (y2[:, 2] > 0)
        return jnp.sum(inl), inl

    ns, inls = jax.vmap(score)(ss, Rs, ts)
    best = jnp.argmax(ns)
    # refine on inliers with weighted Horn
    w = inls[best].astype(jnp.float32)
    s_r, R_r, t_r = horn_sim3(x1, x2, w, fix_scale)
    n_r, inl_r = score(s_r, R_r, t_r)
    use_refined = n_r >= ns[best]
    s_f = jnp.where(use_refined, s_r, ss[best])
    R_f = jnp.where(use_refined, R_r, Rs[best])
    t_f = jnp.where(use_refined, t_r, ts[best])
    inl_f = jnp.where(use_refined, inl_r, inls[best])
    n_f = jnp.maximum(n_r, ns[best])
    return Sim3Result(n_f >= min_inliers, s_f, R_f, t_f, inl_f, n_f)


def _sim3_project_residuals(cam: CameraModel, s, R, t, x1, x2, uv1, uv2,
                            inv_sigma2_1, inv_sigma2_2):
    """Paired forward/inverse reprojection residuals of a Sim3 guess.

    Forward: x1 -> camera 2 via S12; inverse: x2 -> camera 1 via S12^-1
    (the two edge types of OptimizeSim3, EdgeSim3ProjectXYZ /
    EdgeInverseSim3ProjectXYZ, types_seven_dof_expmap.h:99-152).
    Returns (r [N,4], chi2_fwd [N], chi2_inv [N], depth_ok [N]).
    """
    y2 = s * (x1 @ R.T) + t
    z2 = jnp.maximum(y2[:, 2], 1e-6)
    u2 = jnp.stack([cam.fx * y2[:, 0] / z2 + cam.cx,
                    cam.fy * y2[:, 1] / z2 + cam.cy], 1)
    si = 1.0 / s
    Ri = R.T
    ti = -si * (Ri @ t)
    y1 = si * (x2 @ Ri.T) + ti
    z1 = jnp.maximum(y1[:, 2], 1e-6)
    u1 = jnp.stack([cam.fx * y1[:, 0] / z1 + cam.cx,
                    cam.fy * y1[:, 1] / z1 + cam.cy], 1)
    r_fwd = (u2 - uv2) * jnp.sqrt(inv_sigma2_2)[:, None]
    r_inv = (u1 - uv1) * jnp.sqrt(inv_sigma2_1)[:, None]
    chi2_fwd = jnp.sum(r_fwd * r_fwd, 1)
    chi2_inv = jnp.sum(r_inv * r_inv, 1)
    depth_ok = (y1[:, 2] > 1e-3) & (y2[:, 2] > 1e-3)
    return jnp.concatenate([r_fwd, r_inv], 1), chi2_fwd, chi2_inv, depth_ok


@partial(jax.jit, static_argnums=(8, 9))
def optimize_sim3(cam: CameraModel, s0, R0, t0, x1, x2, uv1, uv2,
                  fix_scale: bool = False, iters: int = 8,
                  valid=None, inv_sigma2_1=None, inv_sigma2_2=None,
                  chi2_th: float = 10.0) -> Sim3Result:
    """LM refinement of a Sim3 between two keyframes from matched
    camera-frame point pairs (Optimizer::OptimizeSim3, Optimizer.cc:1116:
    single VertexSim3Expmap, paired forward/inverse projection edges,
    Huber, chi2 outlier removal at th2=10).

    Linearization is jacfwd on the 7-dim left-tangent retraction
    S = exp(xi) o S0 (sigma frozen when fix_scale); each LM iteration
    does one linearization and a 3-value damping ladder of closed-form
    7x7 solves with cost-only evaluation, like the other engines.
    """
    from ..geometry import lie

    N = x1.shape[0]
    if valid is None:
        valid = jnp.ones((N,), bool)
    if inv_sigma2_1 is None:
        inv_sigma2_1 = jnp.ones((N,))
    if inv_sigma2_2 is None:
        inv_sigma2_2 = jnp.ones((N,))

    def residuals(xi, s, R, t, w):
        s_n, R_n, t_n = lie.sim3_retract(s, R, t, xi)
        r, *_ = _sim3_project_residuals(
            cam, s_n, R_n, t_n, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2)
        return (r * w[:, None]).reshape(-1)

    def robust_cost(s, R, t, inlier):
        _, c_f, c_i, dok = _sim3_project_residuals(
            cam, s, R, t, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2)
        chi2 = c_f + c_i
        hub = jnp.where(chi2 > chi2_th,
                        2.0 * jnp.sqrt(chi2_th * jnp.maximum(chi2, 0.0))
                        - chi2_th, chi2)
        hub = jnp.where(dok, hub, 100.0 * chi2_th)
        return jnp.sum(hub * (valid & inlier))

    z7 = jnp.zeros(7)
    scale_mask = jnp.ones(7).at[6].set(jnp.where(fix_scale, 0.0, 1.0))

    def lm_iter(carry, _):
        s, R, t, lam, inlier = carry
        _, c_f, c_i, dok = _sim3_project_residuals(
            cam, s, R, t, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2)
        chi2 = c_f + c_i
        w_huber = jnp.where(chi2 > chi2_th,
                            jnp.sqrt(chi2_th / jnp.maximum(chi2, 1e-12)), 1.0)
        w = jnp.sqrt(w_huber) * (valid & inlier & dok)

        r0 = residuals(z7, s, R, t, w)
        J = jax.jacfwd(residuals)(z7, s, R, t, w)      # [4N, 7]
        H = J.T @ J
        g = J.T @ r0
        H = H * scale_mask[:, None] * scale_mask[None, :]
        H = H + jnp.diag(1.0 - scale_mask)
        g = g * scale_mask
        cost = robust_cost(s, R, t, inlier)

        d = jnp.diag(H)
        def attempt(lam_k):
            Hd = H + lam_k * jnp.diag(d) + 1e-8 * jnp.eye(7)
            dx = -jnp.linalg.solve(Hd, g) * scale_mask
            s_n, R_n, t_n = lie.sim3_retract(s, R, t, dx)
            return s_n, R_n, t_n, robust_cost(s_n, R_n, t_n, inlier)

        lams = lam * jnp.asarray([1.0, 8.0, 64.0])
        s_a, R_a, t_a, cost_a = jax.vmap(attempt)(lams)
        improves = cost_a < cost
        pick = jnp.argmax(improves)
        any_imp = jnp.any(improves)
        s = jnp.where(any_imp, s_a[pick], s)
        R = jnp.where(any_imp, R_a[pick], R)
        t = jnp.where(any_imp, t_a[pick], t)
        lam = jnp.clip(jnp.where(any_imp, lams[pick] * 0.4, lam * 512.0),
                       1e-9, 1e6)
        # chi2 inlier refresh (Optimizer.cc:1183-1215 two-pass semantics)
        _, c_f2, c_i2, dok2 = _sim3_project_residuals(
            cam, s, R, t, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2)
        inlier = valid & (c_f2 < chi2_th) & (c_i2 < chi2_th) & dok2
        return (s, R, t, lam, inlier), None

    init = (jnp.asarray(s0, jnp.float32), R0, t0, jnp.asarray(1e-4), valid)
    (s, R, t, _, inlier), _ = jax.lax.scan(lm_iter, init, None, length=iters)
    n = jnp.sum(inlier)
    return Sim3Result(n >= 20, s, R, t, inlier, n)
