"""Matrix-free global bundle adjustment: Schur-complement PCG.

The scalable counterpart of Optimizer::BundleAdjustment /
GlobalBundleAdjustemnt [sic] (Optimizer.cc:42-253) for camera counts
where ba_core's dense [P, C, 6, 3] coupling tensor would not fit.
Nothing bigger than per-edge arrays and [C,6,6]/[P,3,3] blocks is ever
materialized: the Schur-complement product

    S x = Hcc x - B Hpp^-1 B^T x

is evaluated edge-wise (two segment-sums through the landmark blocks) in
a conjugate-gradient loop with a block-Jacobi (camera-block)
preconditioner.  This is the classic "multicore BA" formulation
(Agarwal et al.) mapped onto segment reductions — and the unit that
shards over a device mesh: every term is a sum over edges, so sharding
the edge/point axes and psum-ing the [C,...] reductions distributes it
(see parallel/dist_ba.py for the mesh wrapper).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import lie
from .ba_core import (BAProblem, CHI2_MONO, CHI2_STEREO, _damp_blocks,
                      edge_chi2, edge_residual_jac)


def _edge_weights(prob: BAProblem, r, is_stereo, depth_ok, robust):
    chi2 = edge_chi2(r, prob.inv_sigma2)
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    w_huber = jnp.where(
        robust & (chi2 > delta2), jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)), 1.0
    )
    w = prob.inv_sigma2 * w_huber * (prob.edge_valid & depth_ok)
    hub = jnp.where(
        chi2 > delta2,
        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 0.0)) - delta2,
        chi2,
    )
    hub = jnp.where(depth_ok, hub, 100.0 * delta2)
    cost = jnp.sum(hub * prob.edge_valid)
    return w, cost


@partial(jax.jit, static_argnums=(2, 3, 4))
def bundle_adjust_cg(cam, prob: BAProblem, iters: int = 10,
                     cg_iters: int = 30, robust: bool = True,
                     lam0: float = 1e-5):
    """LM with matrix-free Schur-PCG inner solves.

    Same contract as ba_core.bundle_adjust: returns
    (R [C,3,3], t [C,3], points [P,3], edge_inlier [E], cost).
    """
    C = prob.R.shape[0]
    P = prob.points.shape[0]
    cam_free = prob.cam_valid & ~prob.cam_fixed
    ci = prob.cam_idx
    pi = prob.pt_idx

    def lm_step(carry, _):
        R, t, X, lam = carry
        p = prob._replace(R=R, t=t, points=X)
        r, Jc, Jp, is_stereo, depth_ok = edge_residual_jac(cam, p)
        w, cost = _edge_weights(prob, r, is_stereo, depth_ok, robust)
        Jc = jnp.where((prob.cam_fixed | ~cam_free)[ci][:, None, None], 0.0, Jc)

        Jcw = Jc * w[:, None, None]
        Jpw = Jp * w[:, None, None]
        Hcc = jnp.zeros((C, 6, 6)).at[ci].add(jnp.einsum("eij,eik->ejk", Jcw, Jc))
        Hpp = jnp.zeros((P, 3, 3)).at[pi].add(jnp.einsum("eij,eik->ejk", Jpw, Jp))
        gc = jnp.zeros((C, 6)).at[ci].add(jnp.einsum("eij,ei->ej", Jcw, r))
        gp = jnp.zeros((P, 3)).at[pi].add(jnp.einsum("eij,ei->ej", Jpw, r))

        Hcc_d = _damp_blocks(Hcc, lam)
        Hpp_d = _damp_blocks(Hpp, lam)
        # closed-form adjugate: batched LU lowering costs us/instance
        from ..geometry.smallsolve import inv3
        Hpp_inv = inv3(Hpp_d + 1e-8 * jnp.eye(3))
        Mc_inv = jnp.linalg.inv(Hcc_d + 1e-6 * jnp.eye(6))  # preconditioner

        def Bt_x(x):
            """B^T x per point: [P,3] from camera vector x [C,6]."""
            u_e = jnp.einsum("eij,ei->ej", Jpw, jnp.einsum("eij,ej->ei", Jc, x[ci]))
            return jnp.zeros((P, 3)).at[pi].add(u_e)

        def B_v(v):
            """B v per camera: [C,6] from point vector v [P,3]."""
            z_e = jnp.einsum("eij,ei->ej", Jcw, jnp.einsum("eij,ej->ei", Jp, v[pi]))
            return jnp.zeros((C, 6)).at[ci].add(z_e)

        def S_mv(x):
            y = jnp.einsum("cij,cj->ci", Hcc_d, x)
            up = Bt_x(x)
            v = jnp.einsum("pij,pj->pi", Hpp_inv, up)
            return y - B_v(v)

        rhs = -gc + B_v(jnp.einsum("pij,pj->pi", Hpp_inv, gp))
        rhs = rhs * cam_free[:, None]

        # preconditioned CG on S dc = rhs
        def M_inv(x):
            return jnp.einsum("cij,cj->ci", Mc_inv, x) * cam_free[:, None]

        def cg_body(carry2, _):
            x, res, z, d = carry2
            Sd = S_mv(d) * cam_free[:, None]
            dSd = jnp.sum(d * Sd)
            alpha = jnp.where(jnp.abs(dSd) > 1e-12, jnp.sum(res * z) / dSd, 0.0)
            x2 = x + alpha * d
            res2 = res - alpha * Sd
            z2 = M_inv(res2)
            beta = jnp.where(
                jnp.sum(res * z) > 1e-12, jnp.sum(res2 * z2) / jnp.sum(res * z), 0.0
            )
            d2 = z2 + beta * d
            return (x2, res2, z2, d2), None

        x0 = jnp.zeros((C, 6))
        z0 = M_inv(rhs)
        (dc, *_), _ = jax.lax.scan(
            cg_body, (x0, rhs, z0, z0), None, length=cg_iters
        )
        dc = dc * cam_free[:, None]

        dp = jnp.einsum("pij,pj->pi", Hpp_inv, -gp - Bt_x(dc))

        R_new, t_new = jax.vmap(lie.se3_retract)(R, t, dc)
        X_new = X + dp * prob.pt_valid[:, None]
        p_new = prob._replace(R=R_new, t=t_new, points=X_new)
        r2, _, _, st2, dok2 = edge_residual_jac(cam, p_new)
        _, cost_new = _edge_weights(prob, r2, st2, dok2, robust)
        better = cost_new < cost
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        X = jnp.where(better, X_new, X)
        lam = jnp.where(better, lam * 0.3, lam * 8.0)
        return (R, t, X, lam), cost_new

    (R, t, X, _), costs = jax.lax.scan(
        lm_step, (prob.R, prob.t, prob.points, jnp.asarray(lam0)), None,
        length=iters,
    )
    p = prob._replace(R=R, t=t, points=X)
    r, _, _, is_stereo, depth_ok = edge_residual_jac(cam, p)
    chi2 = edge_chi2(r, prob.inv_sigma2)
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    inlier = prob.edge_valid & (chi2 <= delta2) & depth_ok
    return R, t, X, inlier, costs[-1]
