"""Bundle adjustment engine: batched robust LM with Schur marginalization.

The array-program replacement for g2o's BlockSolver_6_3 +
OptimizationAlgorithmLevenberg stack used by Optimizer::BundleAdjustment /
LocalBundleAdjustment (Optimizer.cc:54-253, 483-813).  Where g2o walks a
sparse graph of vertex/edge objects, everything here is a padded edge list:

  cam_idx[E], pt_idx[E], uv[E,2], ur[E], inv_sigma2[E], valid[E]

and one LM iteration is a handful of batched einsums + segment reductions:

  residual/Jacobian   [E,3,{6,3}]      (elementwise)
  Hpp = sum per point [P,3,3] -> batched 3x3 inverse
  B   = sum per (point,cam) [P,C,6,3]  (scatter-add)
  S   = Hcc - B Hpp^-1 B^T             (einsum -> matmul)
  dense Cholesky on the [6C, 6C] reduced camera system
  back-substitution for landmarks      (batched 3x3)

g2o's setMarginalized(true) IS the Schur step; setFixed becomes a boolean
mask zeroing camera Jacobians; robust Huber kernels become IRLS weights;
"edge level" outlier exclusion becomes the valid mask.

A matrix-free variant (conjugate gradient on the Schur complement with a
block-Jacobi preconditioner) is provided for camera counts where the dense
[P,C,6,3] tensor would not fit; it is also the unit that distributes over
a device mesh (each shard reduces its edge range, psum the camera system —
see parallel/dist_ba.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie
from ..geometry.camera import CameraModel

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """Padded BA problem.

    poses:  (R [C,3,3], t [C,3]) world->cam
    points: [P, 3]
    cam_fixed: [C] bool — fixed frontier KFs / gauge anchors
    cam_valid: [C] bool, pt_valid: [P] bool
    edges: cam_idx [E] i32, pt_idx [E] i32, uv [E,2], ur [E] (<0 = mono),
           inv_sigma2 [E], valid [E] bool
    """

    R: jnp.ndarray
    t: jnp.ndarray
    points: jnp.ndarray
    cam_fixed: jnp.ndarray
    cam_valid: jnp.ndarray
    pt_valid: jnp.ndarray
    cam_idx: jnp.ndarray
    pt_idx: jnp.ndarray
    uv: jnp.ndarray
    ur: jnp.ndarray
    inv_sigma2: jnp.ndarray
    edge_valid: jnp.ndarray


def edge_residual_jac(cam: CameraModel, prob: BAProblem):
    """Residuals + Jacobians for every edge.

    Returns r [E,3], Jc [E,3,6] (wrt left se3 update of the edge's camera),
    Jp [E,3,3] (wrt the world point), is_stereo [E], depth_ok [E].

    depth_ok gates out edges whose point sits at/behind the camera plane:
    their clamped-z Jacobians are ~1e14-scale and overflow f32 in the
    Hessian products (the reference instead drops such edges via its
    per-iteration chi2/depth checks, Optimizer.cc:705-743).
    """
    Re = prob.R[prob.cam_idx]  # [E,3,3]
    te = prob.t[prob.cam_idx]
    Xw = prob.points[prob.pt_idx]
    xc = jnp.einsum("eij,ej->ei", Re, Xw) + te
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = jnp.where(z < 1e-3, 1e-3, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz

    is_stereo = prob.ur >= 0
    r = jnp.stack(
        [
            u - prob.uv[:, 0],
            v - prob.uv[:, 1],
            jnp.where(is_stereo, ur_pred - prob.ur, 0.0),
        ],
        axis=1,
    )

    du = jnp.stack([cam.fx * iz, jnp.zeros_like(x), -cam.fx * x * iz2], axis=1)
    dv = jnp.stack([jnp.zeros_like(x), cam.fy * iz, -cam.fy * y * iz2], axis=1)
    dr = du + jnp.stack([jnp.zeros_like(x), jnp.zeros_like(x), cam.bf * iz2], axis=1)
    dr = jnp.where(is_stereo[:, None], dr, 0.0)
    dpix = jnp.stack([du, dv, dr], axis=1)  # [E,3,3] d(uvr)/dxc

    eye = jnp.broadcast_to(jnp.eye(3, dtype=xc.dtype), (xc.shape[0], 3, 3))
    J_xc_cam = jnp.concatenate([eye, -lie.hat(xc)], axis=2)  # [E,3,6]
    Jc = dpix @ J_xc_cam
    Jp = dpix @ Re  # dxc/dXw = R
    return r, Jc, Jp, is_stereo, depth_ok


def edge_chi2(r, inv_sigma2):
    return jnp.sum(r * r, axis=1) * inv_sigma2


def build_normal_eqs(cam: CameraModel, prob: BAProblem, robust: bool):
    """One linearization: returns the blocks of the normal equations.

    Hcc [C,6,6] (diag blocks), Hpp [P,3,3], B [P,C,6,3] (cam-point
    coupling, aggregated per (point, cam)), gc [C,6], gp [P,3], cost.
    """
    C = prob.R.shape[0]
    P = prob.points.shape[0]
    r, Jc, Jp, is_stereo, depth_ok = edge_residual_jac(cam, prob)
    chi2 = edge_chi2(r, prob.inv_sigma2)
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    w_huber = jnp.where(
        robust & (chi2 > delta2), jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)), 1.0
    )
    fixed_e = prob.cam_fixed[prob.cam_idx]
    live_e = prob.edge_valid & depth_ok
    w = prob.inv_sigma2 * w_huber * live_e
    Jc = jnp.where(fixed_e[:, None, None], 0.0, Jc)

    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]

    Hcc_e = jnp.einsum("eij,eik->ejk", Jcw, Jc)  # [E,6,6]
    Hpp_e = jnp.einsum("eij,eik->ejk", Jpw, Jp)  # [E,3,3]
    Hcp_e = jnp.einsum("eij,eik->ejk", Jcw, Jp)  # [E,6,3]
    gc_e = jnp.einsum("eij,ei->ej", Jcw, r)      # [E,6]
    gp_e = jnp.einsum("eij,ei->ej", Jpw, r)      # [E,3]

    Hcc = jnp.zeros((C, 6, 6)).at[prob.cam_idx].add(Hcc_e)
    Hpp = jnp.zeros((P, 3, 3)).at[prob.pt_idx].add(Hpp_e)
    gc = jnp.zeros((C, 6)).at[prob.cam_idx].add(gc_e)
    gp = jnp.zeros((P, 3)).at[prob.pt_idx].add(gp_e)
    B = jnp.zeros((P, C, 6, 3)).at[prob.pt_idx, prob.cam_idx].add(Hcp_e)

    # robust cost (for LM accept/reject): huberized chi2; behind-camera
    # edges contribute a flat barrier so a step cannot "improve" cost by
    # pushing points behind the camera
    hub = jnp.where(
        chi2 > delta2,
        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 0.0)) - delta2,
        chi2,
    )
    hub = jnp.where(depth_ok, hub, 100.0 * delta2)
    cost = jnp.sum(hub * prob.edge_valid)
    return Hcc, Hpp, B, gc, gp, cost


def _damp_blocks(H, lam, eps=1e-9):
    d = jnp.diagonal(H, axis1=-2, axis2=-1)
    return H + (lam * d + eps)[..., None] * jnp.eye(H.shape[-1], dtype=H.dtype)


def schur_solve_dense(Hcc, Hpp, B, gc, gp, lam, cam_free_mask):
    """Direct dense solve of the Schur-reduced camera system.

    cam_free_mask: [C] bool — cameras allowed to move.
    Returns (dc [C,6], dp [P,3]).
    """
    from ..geometry.smallsolve import inv3

    C = Hcc.shape[0]
    Hcc_d = _damp_blocks(Hcc, lam)
    Hpp_d = _damp_blocks(Hpp, lam)
    # closed-form batched 3x3 inverse: jnp.linalg.inv lowers to batched
    # LU, a scalar-sequential algorithm that dominates solve latency here
    Hpp_inv = inv3(Hpp_d + 1e-8 * jnp.eye(3))

    # S = blockdiag(Hcc) - B Hpp^-1 B^T   (einsum over points -> [C,C,6,6])
    BH = jnp.einsum("pcij,pjk->pcik", B, Hpp_inv)  # [P,C,6,3]
    S_off = jnp.einsum("pcik,pdlk->cdil", BH, B)   # [C,C,6,6]
    S = -S_off
    S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)

    # reduced rhs: -gc + B Hpp^-1 gp
    rhs = -gc + jnp.einsum("pcik,pk->ci", BH, gp)  # [C,6]

    # flatten to [6C, 6C]; inactive cameras get identity rows
    Sf = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    mask6 = jnp.repeat(cam_free_mask, 6)
    Sf = jnp.where(mask6[:, None] & mask6[None, :], Sf, 0.0)
    Sf = Sf + jnp.diag(jnp.where(mask6, 0.0, 1.0))
    rf = jnp.where(mask6, rhs.reshape(-1), 0.0)

    dc = jax.scipy.linalg.solve(Sf, rf, assume_a="pos").reshape(C, 6)
    dc = jnp.where(cam_free_mask[:, None], dc, 0.0)

    # back-substitute landmarks: dp = Hpp^-1 (-gp - B^T dc)
    Btdc = jnp.einsum("pcij,ci->pj", B, dc)  # [P,3]
    dp = jnp.einsum("pij,pj->pi", Hpp_inv, -gp - Btdc)
    return dc, dp


@partial(jax.jit, static_argnums=(2, 3))
def bundle_adjust(cam: CameraModel, prob: BAProblem, iters: int = 10,
                  robust: bool = True, lam0: float = 1e-5):
    """Robust LM bundle adjustment with dense Schur solve.

    Mirrors LocalBundleAdjustment's 5-then-10 iteration schedule when
    called twice with an outlier re-mask in between; a single call does
    `iters` LM steps with Huber IRLS re-weighting each iteration.

    Returns (R [C,3,3], t [C,3], points [P,3], edge_inlier [E], cost).
    """
    cam_free = prob.cam_valid & ~prob.cam_fixed

    def lm_step(carry, _):
        R, t, X, lam = carry
        p = prob._replace(R=R, t=t, points=X)
        Hcc, Hpp, B, gc, gp, cost = build_normal_eqs(cam, p, robust)
        dc, dp = schur_solve_dense(Hcc, Hpp, B, gc, gp, lam, cam_free)

        R_new, t_new = jax.vmap(lie.se3_retract)(R, t, dc)
        X_new = X + dp * prob.pt_valid[:, None]

        p_new = prob._replace(R=R_new, t=t_new, points=X_new)
        *_, cost_new = build_normal_eqs(cam, p_new, robust)
        better = cost_new < cost
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        X = jnp.where(better, X_new, X)
        lam = jnp.where(better, lam * 0.3, lam * 8.0)
        return (R, t, X, lam), cost_new

    (R, t, X, _), costs = jax.lax.scan(
        lm_step, (prob.R, prob.t, prob.points, jnp.asarray(lam0)), None, length=iters
    )

    # final chi2 classification (Optimizer.cc:705-743)
    p = prob._replace(R=R, t=t, points=X)
    r, _, _, is_stereo, depth_ok = edge_residual_jac(cam, p)
    chi2 = edge_chi2(r, prob.inv_sigma2)
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    # positive-depth check like the reference's pMP->IsInKeyFrame + chi2 gate
    inlier = prob.edge_valid & (chi2 <= delta2) & depth_ok
    return R, t, X, inlier, costs[-1]


# ---------------------------------------------------------------------------
# Grid-structured BA: scatter-free normal equations, tile-aware layout
# ---------------------------------------------------------------------------
#
# Local BA's edge set is the dense [C, N] keyframe-feature grid (every
# feature of every window camera is at most one edge).  A map point is
# observed AT MOST ONCE per keyframe, so the (point, camera) -> feature
# inverse index is well-defined and CONSTANT across LM iterations.  The
# scatter-heavy flat-edge path (build_normal_eqs) spends its time in
# .at[].add; here every per-iteration quantity is a gather + einsum,
# with the single scatter (building the inverse index) done once per
# solve.
#
# LAYOUT RULE: every per-edge array carries the BIG axis (N features /
# P points) LAST and the small Jacobian axes first: r [3,C,N],
# Jc [3,6,C,N], Hpp [3,3,P], B [6,3,C,P].  The rule was set for a
# machine whose tiled memory pads small minor axes many-fold; whether it
# pays on the H100 is not measured (ROADMAP Design 3).


class GridBA(NamedTuple):
    """Grid BA problem over a [C, N] window.

    pt_loc:   [C,N] i32 local point index (-1 = no edge)
    uv/ur/inv_sigma2/edge_valid: per-feature measurement grids
    """

    R: jnp.ndarray            # [C,3,3]
    t: jnp.ndarray            # [C,3]
    points: jnp.ndarray       # [P,3]
    cam_fixed: jnp.ndarray    # [C] bool
    cam_valid: jnp.ndarray    # [C] bool
    pt_valid: jnp.ndarray     # [P] bool
    pt_loc: jnp.ndarray       # [C,N] i32
    uv: jnp.ndarray           # [C,N,2]
    ur: jnp.ndarray           # [C,N]
    inv_sigma2: jnp.ndarray   # [C,N]
    edge_valid: jnp.ndarray   # [C,N] bool


def _grid_residual_jac(cam: CameraModel, R, t, X, g: GridBA):
    """Residual/Jacobian grids: r [C,N,3], Jc [C,N,3,6], Jp [C,N,3,3]."""
    Xg = X[jnp.clip(g.pt_loc, 0)]                      # [C,N,3]
    xc = jnp.einsum("cij,cnj->cni", R, Xg) + t[:, None, :]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    depth_ok = z > 1e-3
    z_safe = jnp.where(z < 1e-3, 1e-3, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz
    is_stereo = g.ur >= 0
    r = jnp.stack(
        [u - g.uv[..., 0], v - g.uv[..., 1],
         jnp.where(is_stereo, ur_pred - g.ur, 0.0)], axis=-1)

    zeros = jnp.zeros_like(x)
    du = jnp.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], axis=-1)
    dv = jnp.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    dr = du + jnp.stack([zeros, zeros, cam.bf * iz2], axis=-1)
    dr = jnp.where(is_stereo[..., None], dr, 0.0)
    dpix = jnp.stack([du, dv, dr], axis=-2)            # [C,N,3,3]

    eye = jnp.broadcast_to(jnp.eye(3, dtype=xc.dtype), xc.shape[:2] + (3, 3))
    J_xc_cam = jnp.concatenate([eye, -lie.hat(xc)], axis=-1)  # [C,N,3,6]
    Jc = dpix @ J_xc_cam
    Jp = jnp.einsum("cnij,cjk->cnik", dpix, R)
    return r, Jc, Jp, is_stereo, depth_ok


def _grid_cost(cam: CameraModel, R, t, X, g: GridBA, chi2_out: bool = False):
    """Robust (huberized) cost only — no Jacobians, no gathers.

    Plane layout: xc is [C,3,N] so every intermediate is a dense [C,N]
    plane (LAYOUT RULE above)."""
    Xg = X[jnp.clip(g.pt_loc, 0)]
    xc = jnp.einsum("cij,cnj->cin", R, Xg) + t[:, :, None]
    z = xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = jnp.where(z < 1e-3, 1e-3, z)
    u = cam.fx * xc[:, 0] / z_safe + cam.cx
    v = cam.fy * xc[:, 1] / z_safe + cam.cy
    ur_pred = u - cam.bf / z_safe
    is_stereo = g.ur >= 0
    e2 = (u - g.uv[..., 0]) ** 2 + (v - g.uv[..., 1]) ** 2 + jnp.where(
        is_stereo, (ur_pred - g.ur) ** 2, 0.0)
    chi2 = e2 * g.inv_sigma2
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    hub = jnp.where(
        chi2 > delta2,
        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 0.0)) - delta2,
        chi2,
    )
    hub = jnp.where(depth_ok, hub, 100.0 * delta2)
    cost = jnp.sum(hub * g.edge_valid)
    if chi2_out:
        return cost, chi2, delta2, depth_ok
    return cost


def _inv3_planes(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of [3, 3, ...] matrices in plane layout (the
    matrix dims LEAD so the big batch axis stays minor)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
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
        jnp.stack([co00, co01, co02], axis=0),
        jnp.stack([co10, co11, co12], axis=0),
        jnp.stack([co20, co21, co22], axis=0),
    ], axis=0)
    return inv / det_safe[None, None]


def _grid_planes_residual_jac(cam: CameraModel, R, t, X, g: GridBA):
    """Plane-layout residuals/Jacobians over the [C,N] grid.

    Returns r [3,C,N], Jc [3,6,C,N], Jp [3,3,C,N], is_stereo [C,N],
    depth_ok [C,N].  First axis = pixel row (u, v, u_r); second axis =
    parameter; the big feature axis is last (see LAYOUT RULE above).
    """
    Xg = X[jnp.clip(g.pt_loc, 0)]                       # [C,N,3] gather
    xc = jnp.einsum("cij,cnj->cin", R, Xg) + t[:, :, None]  # [C,3,N]
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]              # [C,N]
    depth_ok = z > 1e-3
    z_safe = jnp.where(z < 1e-3, 1e-3, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz

    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz
    is_stereo = g.ur >= 0
    r = jnp.stack([u - g.uv[..., 0], v - g.uv[..., 1],
                   jnp.where(is_stereo, ur_pred - g.ur, 0.0)], axis=0)

    zeros = jnp.zeros_like(x)
    du = (cam.fx * iz, zeros, -cam.fx * x * iz2)        # d(u)/dxc
    dv = (zeros, cam.fy * iz, -cam.fy * y * iz2)
    dr = (jnp.where(is_stereo, du[0], 0.0), zeros,
          jnp.where(is_stereo, du[2] + cam.bf * iz2, 0.0))

    def jrow_cam(d):
        """One pixel row of Jc: d(pix)/dxc . [I | -hat(xc)] -> [6,C,N]."""
        dx, dy, dz = d
        return jnp.stack([
            dx, dy, dz,
            dz * y - dy * z,
            dx * z - dz * x,
            dy * x - dx * y,
        ], axis=0)

    Jc = jnp.stack([jrow_cam(du), jrow_cam(dv), jrow_cam(dr)], axis=0)

    def jrow_pt(d):
        """One pixel row of Jp: d(pix)/dxc . R -> [3,C,N]."""
        ds = jnp.stack(d, axis=0)                        # [3,C,N]
        return jnp.einsum("icn,cij->jcn", ds, R)

    Jp = jnp.stack([jrow_pt(du), jrow_pt(dv), jrow_pt(dr)], axis=0)
    return r, Jc, Jp, is_stereo, depth_ok


def schur_solve_planes(Hcc, Hpp, B, gc, gp, lam, cam_free_mask):
    """Dense Schur solve in plane layout.

    Hcc [C,6,6], Hpp [3,3,P], B [6,3,C,P], gc [C,6], gp [3,P].
    Returns (dc [C,6], dp [P,3]).
    """
    C = Hcc.shape[0]
    Hcc_d = _damp_blocks(Hcc, lam)
    dg = jnp.stack([Hpp[0, 0], Hpp[1, 1], Hpp[2, 2]], axis=0)     # [3,P]
    Hpp_d = Hpp + jnp.eye(3)[:, :, None] * (lam * dg + 1e-9)[:, None, :]
    Hpp_inv = _inv3_planes(Hpp_d + 1e-8 * jnp.eye(3)[:, :, None])

    BH = jnp.einsum("ikcp,kjp->ijcp", B, Hpp_inv)        # [6,3,C,P]
    S_off = jnp.einsum("ikcp,lkdp->cdil", BH, B)         # [C,C,6,6]
    S = -S_off
    S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)

    rhs = -gc + jnp.einsum("ikcp,kp->ci", BH, gp)        # [C,6]

    Sf = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    mask6 = jnp.repeat(cam_free_mask, 6)
    Sf = jnp.where(mask6[:, None] & mask6[None, :], Sf, 0.0)
    Sf = Sf + jnp.diag(jnp.where(mask6, 0.0, 1.0))
    rf = jnp.where(mask6, rhs.reshape(-1), 0.0)

    dc = jax.scipy.linalg.solve(Sf, rf, assume_a="pos").reshape(C, 6)
    dc = jnp.where(cam_free_mask[:, None], dc, 0.0)

    Btdc = jnp.einsum("ikcp,ci->kp", B, dc)              # [3,P]
    dp = jnp.einsum("jkp,kp->jp", Hpp_inv, -gp - Btdc)   # [3,P]
    return dc, dp.T


@partial(jax.jit, static_argnums=(2, 3))
def bundle_adjust_grid(cam: CameraModel, g: GridBA, iters: int = 10,
                       robust: bool = True, lam0: float = 1e-5,
                       lam_ladder: tuple = (1.0, 8.0, 64.0)):
    """Robust LM with dense Schur solve over a [C, N] observation grid.

    Same semantics as bundle_adjust (Optimizer::LocalBundleAdjustment)
    but with scatter-free per-iteration assembly in the plane layout
    (see LAYOUT RULE above).  Returns
    (R [C,3,3], t [C,3], points [P,3], edge_inlier [C,N], cost).
    """
    C, N = g.pt_loc.shape
    P = g.points.shape[0]
    cam_free = g.cam_valid & ~g.cam_fixed
    base_valid = g.edge_valid & (g.pt_loc >= 0)

    # --- one-time (point, cam) -> feature inverse index: inv [P, C] in
    # [0, N]; N = "no observation" (arrays below are padded with a zero
    # column at n = N)
    cam_ids = jnp.broadcast_to(jnp.arange(C)[:, None], (C, N))
    n_ids = jnp.broadcast_to(jnp.arange(N)[None, :], (C, N))
    inv = jnp.full((P, C), N, jnp.int32).at[
        jnp.clip(g.pt_loc, 0).reshape(-1), cam_ids.reshape(-1)
    ].min(jnp.where(base_valid, n_ids, N).reshape(-1))
    # linear index into the flattened [..., C*(N+1)] plane arrays,
    # transposed [C,P] so the gather output keeps P minor
    selT = (inv + jnp.arange(C)[None, :] * (N + 1)).T    # [C,P]

    def take(a):
        """Gather per-(cam, point) entries along the LAST axis.

        a [..., C, N] -> padded [..., C*(N+1)] -> out [..., C, P].
        """
        pad_width = [(0, 0)] * (a.ndim - 1) + [(0, 1)]
        ap = jnp.pad(a, pad_width)
        flat = ap.reshape(a.shape[:-2] + (-1,))
        return flat[..., selT]

    def linearize(R, t, X):
        r, Jc, Jp, is_stereo, depth_ok = _grid_planes_residual_jac(
            cam, R, t, X, g)
        chi2 = jnp.sum(r * r, axis=0) * g.inv_sigma2     # [C,N]
        delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        w_huber = jnp.where(
            robust & (chi2 > delta2),
            jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)), 1.0)
        live = base_valid & depth_ok
        w = g.inv_sigma2 * w_huber * live                # [C,N]
        # sqrt-weight trick: fold sqrt(w) into J and r once so every
        # normal-equation product uses the SAME tensors — one fewer
        # [3,*,C,N]-sized gather per iteration than the weighted/
        # unweighted-pair formulation (gathers are the bulk of an
        # iteration's memory traffic)
        sw = jnp.sqrt(w)[None, None]                     # [1,1,C,N]
        Jc = jnp.where(g.cam_fixed[None, None, :, None], 0.0, Jc)
        Jcw = Jc * sw
        Jpw = Jp * sw
        rw = r * sw[0]

        # camera-side: contract pixel-row + feature axes
        Hcc = jnp.einsum("ricn,rjcn->cij", Jcw, Jcw)     # [C,6,6]
        gc = jnp.einsum("ricn,rcn->ci", Jcw, rw)         # [C,6]

        # point-side: gather each point's (<=1 per camera) observation
        Jp_pc = take(Jpw)                                # [3,3,C,P]
        Jcw_pc = take(Jcw)                               # [3,6,C,P]
        r_pc = take(rw)                                  # [3,C,P]

        Hpp = jnp.einsum("rjcp,rkcp->jkp", Jp_pc, Jp_pc)    # [3,3,P]
        gp = jnp.einsum("rjcp,rcp->jp", Jp_pc, r_pc)         # [3,P]
        B = jnp.einsum("ricp,rkcp->ikcp", Jcw_pc, Jp_pc)     # [6,3,C,P]

        hub = jnp.where(
            chi2 > delta2,
            2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 0.0)) - delta2,
            chi2,
        )
        hub = jnp.where(depth_ok, hub, 100.0 * delta2)
        cost = jnp.sum(hub * base_valid)
        return Hcc, Hpp, B, gc, gp, cost

    def lm_step(carry, _):
        R, t, X, lam = carry
        Hcc, Hpp, B, gc, gp, cost = linearize(R, t, X)

        # the linearization (gathers over the grid) is the expensive part;
        # the damped solve is cheap — so try several damping values per
        # linearization and take the smallest-lambda improving step
        # (g2o's OptimizationAlgorithmLevenberg retries the solve on
        # rejection without re-linearizing)
        def attempt(lam_k):
            dc, dp = schur_solve_planes(Hcc, Hpp, B, gc, gp, lam_k, cam_free)
            R_n, t_n = jax.vmap(lie.se3_retract)(R, t, dc)
            X_n = X + dp * g.pt_valid[:, None]
            return R_n, t_n, X_n, _grid_cost(cam, R_n, t_n, X_n, g)

        lams = lam * jnp.asarray(lam_ladder)
        R_a, t_a, X_a, cost_a = jax.vmap(attempt)(lams)
        improves = cost_a < cost
        pick = jnp.argmax(improves)          # first (smallest-lam) improving
        any_imp = jnp.any(improves)
        R = jnp.where(any_imp, R_a[pick], R)
        t = jnp.where(any_imp, t_a[pick], t)
        X = jnp.where(any_imp, X_a[pick], X)
        cost_new = jnp.where(any_imp, cost_a[pick], cost)
        lam = jnp.where(any_imp, lams[pick] * 0.3, lam * 512.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (R, t, X, lam), cost_new

    (R, t, X, _), costs = jax.lax.scan(
        lm_step, (g.R, g.t, g.points, jnp.asarray(lam0)), None, length=iters)

    _, chi2, delta2, depth_ok = _grid_cost(cam, R, t, X, g, chi2_out=True)
    inlier = base_valid & (chi2 <= delta2) & depth_ok
    return R, t, X, inlier, costs[-1]
