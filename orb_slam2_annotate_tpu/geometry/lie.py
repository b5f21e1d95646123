"""SO(3) / SE(3) / Sim(3) Lie-group operations in pure JAX.

Replaces the reference's g2o Lie types (se3quat.h, sim3.h,
types_six_dof_expmap.h, types_seven_dof_expmap.h) and Converter.cc with
functional, batch-friendly exp/log maps and retractions.  Everything is
written to vmap cleanly: all functions take unbatched arguments and are
composed with jax.vmap by callers.

Conventions
-----------
* Rotations are 3x3 matrices, poses are (R, t) pairs with
  ``x_cam = R @ x_world + t`` (world-to-camera, matching the reference's
  Tcw convention).
* se3 tangent vectors are ``[rho(3), phi(3)]`` (translation first), so3
  tangent is ``phi`` with ``R = exp(hat(phi))``.
* sim3 tangent is ``[rho(3), phi(3), sigma(1)]`` with scale ``s = exp(sigma)``.
* float32 throughout; small-angle branches use
  Taylor expansions selected with jnp.where so gradients stay finite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector: hat(v) @ x == cross(v, x)."""
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zero, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def vee(m: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _sinc_sq(sq):
    """sin(sqrt(sq))/sqrt(sq), smooth in sq (NaN-free gradients at 0)."""
    small = sq < 1e-8
    sq_safe = jnp.where(small, 1.0, sq)
    x = jnp.sqrt(sq_safe)
    return jnp.where(small, 1.0 - sq / 6.0, jnp.sin(x) / x)


def _cosc_sq(sq):
    """(1-cos(sqrt(sq)))/sq, smooth in sq."""
    small = sq < 1e-8
    sq_safe = jnp.where(small, 1.0, sq)
    x = jnp.sqrt(sq_safe)
    return jnp.where(small, 0.5 - sq / 24.0, (1.0 - jnp.cos(x)) / sq_safe)


def _sinc(x):
    """sin(x)/x with Taylor fallback."""
    return _sinc_sq(x * x)


def _cosc(x):
    """(1-cos(x))/x^2 with Taylor fallback."""
    return _cosc_sq(x * x)


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: exp: so(3) -> SO(3)."""
    sq = jnp.sum(phi * phi, axis=-1)
    K = hat(phi)
    K2 = K @ K
    a = _sinc_sq(sq)
    b = _cosc_sq(sq)
    eye = jnp.eye(3, dtype=phi.dtype)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """log: SO(3) -> so(3).  Accurate away from theta == pi.

    AD-safe at the identity: theta comes from arctan2(|sin|, cos) rather
    than arccos (whose derivative blows up at cos == 1), and theta/sin
    uses a double-where Taylor guard so jacfwd through this log stays
    finite for R -> I — the pose-graph solver linearizes exactly there
    once the graph is near-consistent.  jacfwd is also kept finite in the
    near-pi branch by flooring the sqrt arguments (axis components that
    are exactly 0 would otherwise put an infinite tangent in the selected
    branch).  jacrev safety is NOT claimed: unselected-branch cotangents
    through arccos/sqrt can still produce NaN in reverse mode.
    """
    cos_theta = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sq = jnp.sum(w * w, axis=-1)                # = sin(theta)^2
    small = sq < 1e-12
    sq_safe = jnp.where(small, 1.0, sq)
    sin_theta = jnp.sqrt(sq_safe)
    theta = jnp.arctan2(sin_theta, cos_theta)
    # theta/sin(theta); small branch: 1 + theta^2/6, theta^2 ~ sq.
    factor = jnp.where(small, 1.0 + sq / 6.0, theta / sin_theta)
    near_pi = cos_theta < -1.0 + 1e-4
    safe = w * factor[..., None]
    # double-where: arccos' derivative is infinite at cos == +-1; only
    # evaluate it on inputs where the near-pi branch is selected.
    theta = jnp.where(
        near_pi, jnp.arccos(jnp.where(near_pi, cos_theta, 0.0)), theta
    )
    # Near pi: axis from the symmetric part. B = (R + I)/2 = I + sin.. use
    # diagonal of R: R_ii = cos t + (1-cos t) a_i^2.
    axis_sq = jnp.clip((jnp.diagonal(R) - cos_theta) / (1.0 - cos_theta + _EPS), 0.0, 1.0)
    # floor before sqrt: for a ~pi rotation about a coordinate axis two
    # components of axis_sq are exactly 0 and sqrt's tangent is infinite
    # in the SELECTED branch; the floor trades that for a ~sqrt(_EPS)
    # axis error, negligible at the 1e-4 near-pi band.
    axis = jnp.sqrt(jnp.maximum(jnp.where(near_pi, axis_sq, 1.0), _EPS))
    # fix signs using the off-diagonal skew part (w has sign info unless exactly pi)
    sign = jnp.where(jnp.abs(w) > 1e-7, jnp.sign(w), 1.0)
    pi_sol = theta * axis * sign
    return jnp.where(near_pi, pi_sol, safe)


def so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian J_l of SO(3): exp(hat(phi+dphi)) ~ exp(hat(J_l dphi)) exp(hat(phi))."""
    sq = jnp.sum(phi * phi, axis=-1)
    K = hat(phi)
    K2 = K @ K
    b = _cosc_sq(sq)
    # c = (theta - sin theta)/theta^3, smooth in theta^2
    small = sq < 1e-8
    sq_safe = jnp.where(small, 1.0, sq)
    ts = jnp.sqrt(sq_safe)
    c = jnp.where(small, 1.0 / 6.0 - sq / 120.0, (ts - jnp.sin(ts)) / (ts * sq_safe))
    eye = jnp.eye(3, dtype=phi.dtype)
    return eye + b[..., None, None] * K + c[..., None, None] * K2


def se3_exp(xi: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """exp: se(3) -> SE(3).  xi = [rho, phi] -> (R, t) with t = J_l(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    J = so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", J, rho)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """log: SE(3) -> se(3)."""
    from .smallsolve import solve3

    phi = so3_log(R)
    J = so3_left_jacobian(phi)
    rho = solve3(J, t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inverse(R: jnp.ndarray, t: jnp.ndarray):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): first apply b, then a."""
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_apply(R, t, x):
    return jnp.einsum("...ij,...j->...i", R, x) + t


def se3_retract(R, t, xi):
    """Left retraction used by all solvers: T <- exp(xi) o T."""
    dR, dt = se3_exp(xi)
    return se3_compose(dR, dt, R, t)


# ---------------------------------------------------------------------------
# Sim(3) — used by loop closing (Sim3Solver.cc, types_seven_dof_expmap.h)
# ---------------------------------------------------------------------------


def sim3_exp(xi: jnp.ndarray):
    """exp: sim(3) -> Sim(3).  xi = [rho, phi, sigma] -> (s, R, t).

    t = W rho with the closed-form W = C*I + A*hat(phi) + B*hat(phi)^2
    (Strasdat's thesis eq. for Sim(3) exponential):

      C = (s - 1)/sigma
      A = (sigma*s*sin(th) + (1 - s*cos(th))*th) / (th*(sigma^2 + th^2))
      B = (C - ((s*cos(th) - 1)*sigma + s*sin(th)*th)/(sigma^2 + th^2)) / th^2

    with Taylor limits as theta -> 0 and sigma -> 0.
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    theta = jnp.linalg.norm(phi, axis=-1)
    K = hat(phi)
    K2 = K @ K

    eps = 1e-5
    sig_small = jnp.abs(sigma) < eps
    th_small = theta < eps
    sig_safe = jnp.where(sig_small, 1.0, sigma)
    th_safe = jnp.where(th_small, 1.0, theta)

    C = jnp.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig_safe)

    b = s * jnp.cos(theta)  # s*cos(th)
    a = s * jnp.sin(theta)  # s*sin(th)
    den = sigma * sigma + theta * theta
    den_safe = jnp.where(th_small & sig_small, 1.0, den)

    A_gen = (sigma * a + (1.0 - b) * th_safe) / (th_safe * den_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * th_safe) / den_safe) / (th_safe * th_safe)

    # theta -> 0 limits (K, K2 are O(theta) there, so modest accuracy suffices)
    A_th0 = jnp.where(
        sig_small, 0.5 + sigma / 3.0, ((sig_safe - 1.0) * s + 1.0) / (sig_safe * sig_safe)
    )
    B_th0 = jnp.where(
        sig_small,
        1.0 / 6.0 + sigma / 4.0,
        ((0.5 * sig_safe * sig_safe - sig_safe + 1.0) * s - 1.0) / (sig_safe**3),
    )
    A = jnp.where(th_small, A_th0, A_gen)
    B = jnp.where(th_small, B_th0, B_gen)

    eye = jnp.eye(3, dtype=xi.dtype)
    W = C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * K2
    t = jnp.einsum("...ij,...j->...i", W, rho)
    return s, R, t


def sim3_apply(s, R, t, x):
    return s[..., None] * jnp.einsum("...ij,...j->...i", R, x) + t


def sim3_inverse(s, R, t):
    s_inv = 1.0 / s
    R_inv = jnp.swapaxes(R, -1, -2)
    t_inv = -s_inv[..., None] * jnp.einsum("...ij,...j->...i", R_inv, t)
    return s_inv, R_inv, t_inv


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa,Ra,ta) o (sb,Rb,tb)."""
    return (
        sa * sb,
        Ra @ Rb,
        sa[..., None] * jnp.einsum("...ij,...j->...i", Ra, tb) + ta,
    )


def sim3_retract(s, R, t, xi):
    ds, dR, dt = sim3_exp(xi)
    return sim3_compose(ds, dR, dt, s, R, t)


def sim3_log(s, R, t):
    """log: Sim(3) -> sim(3) via inverting t = W rho numerically."""
    sigma = jnp.log(s)
    phi = so3_log(R)
    xi0 = jnp.concatenate([jnp.zeros_like(t), phi, sigma[..., None]], axis=-1)
    # W depends only on (phi, sigma); recover it by probing sim3_exp linearly.
    basis = jnp.eye(3, dtype=t.dtype)

    def col(e):
        xi = jnp.concatenate([e, phi, sigma[..., None]], axis=-1)
        _, _, tc = sim3_exp(xi)
        return tc

    from .smallsolve import solve3

    W = jnp.stack([col(basis[i]) for i in range(3)], axis=-1)
    rho = solve3(W, t)
    del xi0
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Quaternion helpers (trajectory export uses TUM qx qy qz qw format,
# reference System.cc:327-477)
# ---------------------------------------------------------------------------


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion [qx, qy, qz, qw], branch-free.

    Computes all four Shepperd candidates and picks the best-conditioned.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # candidate 0: qw biggest
    q0 = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], axis=-1)
    # candidate 1: qx biggest
    q1 = jnp.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    # candidate 2: qy biggest
    q2 = jnp.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1)
    # candidate 3: qz biggest
    q3 = jnp.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], axis=-1)

    cands = jnp.stack([q0, q1, q2, q3], axis=-2)  # [..., 4, 4]
    norms = jnp.sum(cands * cands, axis=-1)
    idx = jnp.argmax(norms, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion [qx,qy,qz,qw] -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / jnp.maximum(n, _EPS)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
