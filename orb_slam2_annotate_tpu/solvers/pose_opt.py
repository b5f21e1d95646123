"""Motion-only pose optimization (the replacement of g2o PoseOptimization).

Reference: Optimizer::PoseOptimization (Optimizer.cc:256-476): one SE3
vertex, N unary mono/stereo reprojection edges with information
I * invSigma2(octave), Huber delta sqrt(5.991) mono / sqrt(7.815) stereo,
4 rounds of (10 LM iterations + chi2 inlier reclassification), robust
kernel dropped after round 2.

Design: the whole thing is one jitted program.  Edges are a padded
array with a validity mask; each LM iteration computes all residuals and
analytic Jacobians batched [N, 2, 6], reduces H = J^T W J (6x6) and
g = J^T W r with masked sums, and solves the damped 6x6 system.  The
"level 0/1" outlier mechanism of g2o becomes a boolean mask recomputed
between rounds; "drop the robust kernel" becomes a flag that switches the
Huber weight to 1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from ..geometry.camera import CameraModel

CHI2_MONO = 5.991    # 95% chi2, 2 dof (Optimizer.cc:391)
CHI2_STEREO = 7.815  # 95% chi2, 3 dof


class PoseObs(NamedTuple):
    """Padded unary observation set for one frame.

    xw:       [N, 3] world points
    uv:       [N, 2] observed (undistorted) pixels
    ur:       [N]   observed right-image u (stereo/RGBD); <0 means mono obs
    inv_sigma2: [N] information scale from the keypoint octave
    valid:    [N]   bool
    """

    xw: jnp.ndarray
    uv: jnp.ndarray
    ur: jnp.ndarray
    inv_sigma2: jnp.ndarray
    valid: jnp.ndarray


def _residual_jac(cam: CameraModel, R, t, obs: PoseObs):
    """Batched residuals and Jacobians wrt the left-multiplied se3 update.

    Plane layout: returns (r [3,N], J [3,6,N], is_stereo [N],
    depth_ok [N]) — the big observation axis is LAST (ba_core's LAYOUT
    RULE, unmeasured on the H100).  Mono rows have r[2]=0, J[2]=0 so
    they contribute 2 dof.  depth_ok gates rows whose point sits
    at/behind the camera: their clamped-z Jacobians are enormous and
    would drown the Hessian (the reference never feeds such points:
    isInFrustum pre-gates, Frame.cc:297).
    """
    xc = obs.xw @ R.T + t  # [N, 3]
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = jnp.where(z < 1e-3, 1e-3, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz

    is_stereo = obs.ur >= 0
    r_u = u - obs.uv[:, 0]
    r_v = v - obs.uv[:, 1]
    r_r = jnp.where(is_stereo, ur_pred - obs.ur, 0.0)
    r = jnp.stack([r_u, r_v, r_r], axis=0)  # [3,N]

    zeros = jnp.zeros_like(x)
    du = (cam.fx * iz, zeros, -cam.fx * x * iz2)     # d(u)/dxc rows
    dv = (zeros, cam.fy * iz, -cam.fy * y * iz2)
    st = is_stereo
    dr = (jnp.where(st, du[0], 0.0), zeros,
          jnp.where(st, du[2] + cam.bf * iz2, 0.0))

    # J row for one pixel row d = d(pix)/dxc against J_xc = [I | -hat(xc)]:
    # translation part = d; rotation part = d . (-hat(xc)) computed
    # componentwise (no [N,3,6] intermediates)
    def jrow(d):
        dx, dy, dz = d
        return jnp.stack([
            dx, dy, dz,
            dz * y - dy * z,
            dx * z - dz * x,
            dy * x - dx * y,
        ], axis=0)  # [6,N]

    J = jnp.stack([jrow(du), jrow(dv), jrow(dr)], axis=0)  # [3,6,N]
    return r, J, is_stereo, depth_ok


def _chi2(r, inv_sigma2, is_stereo):
    e2 = jnp.sum(r * r, axis=0)
    return e2 * inv_sigma2


def _huber_weight(chi2, delta2, robust):
    """Huber IRLS weight on the chi2 (residual already whitened by W)."""
    w = jnp.where(chi2 > delta2, jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)), 1.0)
    return jnp.where(robust, w, 1.0)


def _pose_cost(cam: CameraModel, R, t, obs: PoseObs, mask, delta2):
    """Huberized chi2 cost without Jacobians (cheap accept/reject eval)."""
    xc = obs.xw @ R.T + t
    z = xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = jnp.where(depth_ok, z, 1e-3)
    u = cam.fx * xc[:, 0] / z_safe + cam.cx
    v = cam.fy * xc[:, 1] / z_safe + cam.cy
    ur_pred = u - cam.bf / z_safe
    is_stereo = obs.ur >= 0
    e2 = (u - obs.uv[:, 0]) ** 2 + (v - obs.uv[:, 1]) ** 2 + jnp.where(
        is_stereo, (ur_pred - obs.ur) ** 2, 0.0)
    chi2 = e2 * obs.inv_sigma2
    hub = jnp.where(
        chi2 > delta2,
        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 0.0)) - delta2,
        chi2,
    )
    hub = jnp.where(depth_ok, hub, 100.0 * delta2)
    return jnp.sum(hub * mask)


def optimize_pose(cam: CameraModel, R0, t0, obs: PoseObs,
                  rounds: int = 4, iters_per_round: int = 5,
                  lm_lambda0: float = 1e-3):
    """The reference's 4-round robust LM schedule with chi2
    reclassification between rounds (Optimizer.cc:391-464).  Jit-safe.

    Each LM iteration does ONE linearization
    and then tries a 3-value damping ladder with cost-only evaluations
    (vmapped, closed-form 6x6 block-Schur solves — no LU).  g2o retries
    the solve on rejection without re-linearizing too
    (OptimizationAlgorithmLevenberg); the ladder makes those retries
    data-parallel instead of sequential, so 4x5 iterations here make at
    least as much progress as the reference's 4x10 while keeping the
    sequential dependency chain — the latency driver — half as deep.

    Returns (R, t, inlier_mask [N], n_inliers).
    """
    from ..geometry.smallsolve import solve6_spd

    delta2_all = jnp.where(obs.ur >= 0, CHI2_STEREO, CHI2_MONO)

    def lm_round(carry, round_idx):
        R, t, inlier = carry
        robust = round_idx < 2  # kernel dropped after 2 rounds (Optimizer.cc:447)
        mask_f = (obs.valid & inlier).astype(jnp.float32)

        def lm_iter(carry2, _):
            R, t, lam = carry2
            r, J, is_stereo, depth_ok = _residual_jac(cam, R, t, obs)
            chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
            w_huber = _huber_weight(chi2, delta2_all, robust)
            w = obs.inv_sigma2 * w_huber * (obs.valid & inlier & depth_ok)

            # plane layout: J [3,6,N], r [3,N]; contract pixel-row + obs axes
            Jw = J * w[None, None, :]
            H = jnp.einsum("rin,rjn->ij", Jw, J)  # [6,6]
            g = jnp.einsum("rin,rn->i", Jw, r)
            cost = _pose_cost(cam, R, t, obs, mask_f, delta2_all)

            d = jnp.diag(H)
            def attempt(lam_k):
                Hd = H + lam_k * jnp.diag(d) + 1e-8 * jnp.eye(6)
                dx = -solve6_spd(Hd, g)
                R_n, t_n = lie.se3_retract(R, t, dx)
                return R_n, t_n, _pose_cost(cam, R_n, t_n, obs, mask_f,
                                            delta2_all)

            lams = lam * jnp.asarray([1.0, 8.0, 64.0])
            R_a, t_a, cost_a = jax.vmap(attempt)(lams)
            improves = cost_a < cost
            pick = jnp.argmax(improves)      # first (smallest-lam) improving
            any_imp = jnp.any(improves)
            R = jnp.where(any_imp, R_a[pick], R)
            t = jnp.where(any_imp, t_a[pick], t)
            lam = jnp.where(any_imp, lams[pick] * 0.4, lam * 512.0)
            lam = jnp.clip(lam, 1e-9, 1e6)
            return (R, t, lam), None

        (R, t, _), _ = jax.lax.scan(
            lm_iter, (R, t, jnp.asarray(lm_lambda0)), None, length=iters_per_round
        )

        # chi2 reclassification (Optimizer.cc:412-446)
        r, _, is_stereo, depth_ok = _residual_jac(cam, R, t, obs)
        chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
        inlier = obs.valid & (chi2 <= delta2_all) & depth_ok
        return (R, t, inlier), None

    inlier0 = obs.valid
    (R, t, inlier), _ = jax.lax.scan(
        lm_round, (R0, t0, inlier0), jnp.arange(rounds)
    )
    return R, t, inlier, jnp.sum(inlier)
