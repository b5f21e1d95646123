"""Sim(3) pose-graph optimization (the essential graph).

Replaces Optimizer::OptimizeEssentialGraph (Optimizer.cc:833-1103):
7-dof similarity vertices per keyframe, edges from the spanning tree,
strong-covisibility pairs (w >= 100), and loop closures; residual of edge
(i, j) with measurement S_ji is  r = log_sim3(S_ji * S_i * S_j^-1) in
R^7.  Gauss-Newton with analytic-free Jacobians: jax.jacfwd on the 7-dim
tangent retraction per edge endpoint, vmapped over the padded edge list,
scatter-assembled into a dense [7K, 7K] system (K <= a few hundred keeps
the dense Cholesky small).

After convergence, keyframe poses are recovered as SE3 = [R, t/s]
(Optimizer.cc:1073-1081) and map points are transformed by their
reference keyframe's correction (Optimizer.cc:1087-1103 semantics — done
by the caller in pipeline/loop_closing.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lie


class PoseGraphProblem(NamedTuple):
    """Padded Sim3 pose-graph.

    s, R, t: [K] / [K,3,3] / [K,3] current Sim3 world->cam per keyframe
    fixed:   [K] bool (the loop keyframe is held fixed, Optimizer.cc:906)
    valid:   [K] bool
    e_i, e_j: [E] i32 edge endpoints
    e_s, e_R, e_t: edge measurements S_ji (pose of i in j's frame):
                   [E] / [E,3,3] / [E,3]
    e_valid: [E] bool
    e_weight: [E] f32 (1.0 normally; loop edges can be upweighted)
    """

    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    fixed: jnp.ndarray
    valid: jnp.ndarray
    e_i: jnp.ndarray
    e_j: jnp.ndarray
    e_s: jnp.ndarray
    e_R: jnp.ndarray
    e_t: jnp.ndarray
    e_valid: jnp.ndarray
    e_weight: jnp.ndarray


def edge_measurement(si, Ri, ti, sj, Rj, tj):
    """S_ji = S_j * S_i^-1 (measurement construction, Optimizer.cc:920)."""
    s_inv, R_inv, t_inv = lie.sim3_inverse(si, Ri, ti)
    return lie.sim3_compose(sj, Rj, tj, s_inv, R_inv, t_inv)


def _edge_residual(xi_i, xi_j, Si, Sj, Sji):
    """r = log(S_ji * (exp(xi_i) S_i) * (exp(xi_j) S_j)^-1) in R^7."""
    si, Ri, ti = lie.sim3_retract(*Si, xi_i)
    sj, Rj, tj = lie.sim3_retract(*Sj, xi_j)
    s_inv, R_inv, t_inv = lie.sim3_inverse(sj, Rj, tj)
    s1, R1, t1 = lie.sim3_compose(si, Ri, ti, s_inv, R_inv, t_inv)
    s2, R2, t2 = lie.sim3_compose(*Sji, s1, R1, t1)
    return lie.sim3_log(s2, R2, t2)


@partial(jax.jit, static_argnums=(1,))
def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                        lam0: float = 1e-6):
    """Gauss-Newton/LM over the Sim3 graph.  Returns (s, R, t, cost)."""
    K = prob.s.shape[0]
    E = prob.e_i.shape[0]
    z7 = jnp.zeros(7)

    def residuals_and_jacs(s, R, t):
        Si = (s[prob.e_i], R[prob.e_i], t[prob.e_i])
        Sj = (s[prob.e_j], R[prob.e_j], t[prob.e_j])
        Sji = (prob.e_s, prob.e_R, prob.e_t)

        def one(ei):
            Si_e = jax.tree.map(lambda a: a[ei], Si)
            Sj_e = jax.tree.map(lambda a: a[ei], Sj)
            Sji_e = jax.tree.map(lambda a: a[ei], Sji)
            r = _edge_residual(z7, z7, Si_e, Sj_e, Sji_e)
            Ji = jax.jacfwd(lambda x: _edge_residual(x, z7, Si_e, Sj_e, Sji_e))(z7)
            Jj = jax.jacfwd(lambda x: _edge_residual(z7, x, Si_e, Sj_e, Sji_e))(z7)
            return r, Ji, Jj

        return jax.vmap(one)(jnp.arange(E))

    def gn_step(carry, _):
        s, R, t, lam = carry
        r, Ji, Jj = residuals_and_jacs(s, R, t)  # [E,7], [E,7,7] x2
        w = prob.e_weight * prob.e_valid
        cost = jnp.sum(jnp.sum(r * r, 1) * w)

        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        H = jnp.zeros((K, K, 7, 7))
        H = H.at[prob.e_i, prob.e_i].add(jnp.einsum("eij,eik->ejk", Jiw, Ji))
        H = H.at[prob.e_j, prob.e_j].add(jnp.einsum("eij,eik->ejk", Jjw, Jj))
        H = H.at[prob.e_i, prob.e_j].add(jnp.einsum("eij,eik->ejk", Jiw, Jj))
        H = H.at[prob.e_j, prob.e_i].add(jnp.einsum("eij,eik->ejk", Jjw, Ji))
        g = jnp.zeros((K, 7))
        g = g.at[prob.e_i].add(jnp.einsum("eij,ei->ej", Jiw, r))
        g = g.at[prob.e_j].add(jnp.einsum("eij,ei->ej", Jjw, r))

        free = prob.valid & ~prob.fixed
        mask7 = jnp.repeat(free, 7)
        Hf = H.transpose(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hf = jnp.where(mask7[:, None] & mask7[None, :], Hf, 0.0)
        d = jnp.diagonal(Hf)
        Hf = Hf + jnp.diag(lam * d + jnp.where(mask7, 1e-8, 1.0))
        gf = jnp.where(mask7, g.reshape(-1), 0.0)
        dx = -jnp.linalg.solve(Hf, gf).reshape(K, 7)
        dx = jnp.where(free[:, None], dx, 0.0)

        s_new, R_new, t_new = jax.vmap(lie.sim3_retract)(s, R, t, dx)
        r2, _, _ = residuals_and_jacs(s_new, R_new, t_new)
        cost_new = jnp.sum(jnp.sum(r2 * r2, 1) * w)
        better = cost_new < cost
        s = jnp.where(better, s_new, s)
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        lam = jnp.where(better, lam * 0.3, lam * 10.0)
        return (s, R, t, lam), cost

    (s, R, t, _), costs = jax.lax.scan(
        gn_step, (prob.s, prob.R, prob.t, jnp.asarray(lam0)), None, length=iters
    )
    return s, R, t, costs[-1]


@partial(jax.jit, static_argnums=(1, 2))
def optimize_pose_graph_cg(prob: PoseGraphProblem, iters: int = 20,
                           cg_iters: int = 60, lam0: float = 1e-6):
    """Matrix-free LM over the Sim3 graph: the normal-equation matvec is
    assembled EDGE-WISE (gather endpoint tangents, two 7x7 block products
    per edge, scatter-add), so memory is O(E*49) instead of the dense
    path's O(K^2*49) — the Optimizer.cc:833 essential graph at reference
    scale (K in the thousands) stays solvable on one chip.  Solved with
    block-Jacobi preconditioned CG under a fixed iteration budget
    (compiler-friendly; no data-dependent control flow).

    Same semantics/returns as optimize_pose_graph.
    """
    K = prob.s.shape[0]
    E = prob.e_i.shape[0]
    z7 = jnp.zeros(7)

    def residuals_and_jacs(s, R, t):
        Si = (s[prob.e_i], R[prob.e_i], t[prob.e_i])
        Sj = (s[prob.e_j], R[prob.e_j], t[prob.e_j])
        Sji = (prob.e_s, prob.e_R, prob.e_t)

        def one(ei):
            Si_e = jax.tree.map(lambda a: a[ei], Si)
            Sj_e = jax.tree.map(lambda a: a[ei], Sj)
            Sji_e = jax.tree.map(lambda a: a[ei], Sji)
            r = _edge_residual(z7, z7, Si_e, Sj_e, Sji_e)
            Ji = jax.jacfwd(lambda x: _edge_residual(x, z7, Si_e, Sj_e, Sji_e))(z7)
            Jj = jax.jacfwd(lambda x: _edge_residual(z7, x, Si_e, Sj_e, Sji_e))(z7)
            return r, Ji, Jj

        return jax.vmap(one)(jnp.arange(E))

    free = prob.valid & ~prob.fixed

    def gn_step(carry, _):
        s, R, t, lam = carry
        r, Ji, Jj = residuals_and_jacs(s, R, t)  # [E,7], [E,7,7] x2
        w = prob.e_weight * prob.e_valid
        cost = jnp.sum(jnp.sum(r * r, 1) * w)
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]

        # gradient g[K,7] and block-diagonal D[K,7,7] by scatter-add
        g = jnp.zeros((K, 7))
        g = g.at[prob.e_i].add(jnp.einsum("eij,ei->ej", Jiw, r))
        g = g.at[prob.e_j].add(jnp.einsum("eij,ei->ej", Jjw, r))
        D = jnp.zeros((K, 7, 7))
        D = D.at[prob.e_i].add(jnp.einsum("eij,eik->ejk", Jiw, Ji))
        D = D.at[prob.e_j].add(jnp.einsum("eij,eik->ejk", Jjw, Jj))
        Dd = D + (lam * jnp.einsum("kii->ki", D) + 1e-8)[:, :, None] \
            * jnp.eye(7)

        def hvp(x):
            """(J^T W J + lam diag) x, edge-wise; x [K,7]."""
            xi = x[prob.e_i]
            xj = x[prob.e_j]
            u = (jnp.einsum("eij,ej->ei", Ji, xi)
                 + jnp.einsum("eij,ej->ei", Jj, xj)) * w[:, None]
            y = jnp.zeros((K, 7))
            y = y.at[prob.e_i].add(jnp.einsum("eij,ei->ej", Ji, u))
            y = y.at[prob.e_j].add(jnp.einsum("eij,ei->ej", Jj, u))
            y = y + (lam * jnp.einsum("kii->ki", D) + 1e-8) * x
            return jnp.where(free[:, None], y, x)  # identity on fixed

        # block-Jacobi preconditioner from the damped diagonal blocks
        Dinv = jnp.linalg.inv(
            Dd + jnp.eye(7) * (~free[:, None, None]))

        def M_inv(x):
            y = jnp.einsum("kij,kj->ki", Dinv, x)
            return jnp.where(free[:, None], y, x)

        b = jnp.where(free[:, None], -g, 0.0)

        def cg_body(carry2, _):
            x, rr, p, rz = carry2
            Ap = hvp(p)
            denom = jnp.sum(p * Ap)
            alpha = jnp.where(denom > 1e-20, rz / denom, 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = M_inv(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(rz > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            return (x, rr, p, rz_new), None

        x0 = jnp.zeros((K, 7))
        z0 = M_inv(b)
        (dx, _, _, _), _ = jax.lax.scan(
            cg_body, (x0, b, z0, jnp.sum(b * z0)), None, length=cg_iters)
        dx = jnp.where(free[:, None], dx, 0.0)

        s_new, R_new, t_new = jax.vmap(lie.sim3_retract)(s, R, t, dx)
        r2, _, _ = residuals_and_jacs(s_new, R_new, t_new)
        cost_new = jnp.sum(jnp.sum(r2 * r2, 1) * w)
        better = cost_new < cost
        s = jnp.where(better, s_new, s)
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        lam = jnp.where(better, lam * 0.3, lam * 10.0)
        return (s, R, t, lam), cost

    (s, R, t, _), costs = jax.lax.scan(
        gn_step, (prob.s, prob.R, prob.t, jnp.asarray(lam0)), None,
        length=iters)
    return s, R, t, costs[-1]
