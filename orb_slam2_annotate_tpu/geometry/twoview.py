"""Two-view geometry: triangulation, F/H estimation, E decomposition.

Replaces the reference's Initializer.cc internals (Triangulate:829,
ComputeF21:266, ComputeH21:230, DecomposeE:1034, CheckRT:913) with
batch-first JAX: every solver here is written for a leading hypothesis
batch axis so 200 RANSAC models are one vmapped SVD instead of the
reference's sequential loop (Initializer.cc:88-131).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .lie import hat


def triangulate_dlt(P1: jnp.ndarray, P2: jnp.ndarray, x1: jnp.ndarray,
                    x2: jnp.ndarray) -> jnp.ndarray:
    """Linear (DLT) triangulation of one point from two projections.

    P1, P2: [3,4] projection matrices (K[R|t] or normalized [R|t]).
    x1, x2: [2] pixel/normalized observations.  Returns [3] world point.
    Same construction as reference Initializer.cc:829-851 but solved
    INHOMOGENEOUSLY (fix X_w = 1): argmin |A[:, :3] X + A[:, 3]| via the
    closed-form 3x3 normal equations.  The homogeneous eigh(A^T A)
    route lowers to an iterative eigensolver per point, far costlier
    for one keyframe's 20x1024 pair grid than this closed form.  The
    w=1 chart only degrades for points at infinity, which the
    callers' parallax/depth gates reject anyway.
    """
    from .smallsolve import solve3

    A = jnp.stack(
        [
            x1[0] * P1[2] - P1[0],
            x1[1] * P1[2] - P1[1],
            x2[0] * P2[2] - P2[0],
            x2[1] * P2[2] - P2[1],
        ]
    )
    A3 = A[:, :3]
    AtA = A3.T @ A3
    Atb = -A3.T @ A[:, 3]
    return solve3(AtA + 1e-12 * jnp.eye(3), Atb)


triangulate_dlt_batch = jax.vmap(triangulate_dlt, in_axes=(None, None, 0, 0))


def _normalize_points(pts: jnp.ndarray, mask: jnp.ndarray):
    """Hartley normalization (mean 0, mean abs dev 1) over masked points.

    pts: [N,2], mask: [N] bool.  Returns (normalized pts [N,2], T [3,3]).
    Mirrors reference Initializer.cc:771-827 semantics.
    """
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = (pts - mean) * w[:, None]
    mdev = jnp.sum(jnp.abs(d), axis=0) / n
    s = 1.0 / jnp.maximum(mdev, 1e-8)
    npts = (pts - mean) * s
    T = jnp.array(
        [
            [s[0], 0.0, -mean[0] * s[0]],
            [0.0, s[1], -mean[1] * s[1]],
            [0.0, 0.0, 1.0],
        ],
        dtype=pts.dtype,
    )
    return npts, T


def fit_fundamental_8pt(x1: jnp.ndarray, x2: jnp.ndarray,
                        mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Normalized 8-point fundamental matrix from [N>=8,2] pixel matches.

    Returns F21 (x2^T F x1 = 0), rank-2 enforced.  `mask` selects rows
    (least-squares refit on inliers); SVD of A (not eigh of A^T A) keeps
    f32 accuracy — the squared system loses the digits the essential-matrix
    decomposition needs.  Batch with vmap for RANSAC (replaces
    Initializer.cc ComputeF21:266).
    """
    if mask is None:
        mask = jnp.ones(x1.shape[0], bool)
    w = mask.astype(x1.dtype)
    n1, T1 = _normalize_points(x1, mask)
    n2, T2 = _normalize_points(x2, mask)
    u1, v1 = n1[:, 0], n1[:, 1]
    u2, v2 = n2[:, 0], n2[:, 1]
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, jnp.ones_like(u1)],
        axis=-1,
    ) * w[:, None]
    # pad one zero row so Vt is the full 9x9 basis even for the minimal
    # 8-row system (full_matrices=False would drop the null vector)
    A = jnp.concatenate([A, jnp.zeros((1, 9), A.dtype)], axis=0)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    f = Vt[-1].reshape(3, 3)
    # rank-2 projection
    U, S, Vt2 = jnp.linalg.svd(f)
    S = S.at[2].set(0.0)
    Fn = (U * S[None, :]) @ Vt2
    return T2.T @ Fn @ T1


def fit_homography_dlt(x1: jnp.ndarray, x2: jnp.ndarray,
                       mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Normalized DLT homography from [N>=4,2] matches: x2 ~ H21 x1.

    Replaces Initializer.cc ComputeH21:230.  `mask` selects rows.
    """
    if mask is None:
        mask = jnp.ones(x1.shape[0], bool)
    w = mask.astype(x1.dtype)
    n1, T1 = _normalize_points(x1, mask)
    n2, T2 = _normalize_points(x2, mask)
    u1, v1 = n1[:, 0], n1[:, 1]
    u2, v2 = n2[:, 0], n2[:, 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    r1 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], axis=-1)
    r2 = jnp.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], axis=-1)
    A = jnp.concatenate(
        [r1 * w[:, None], r2 * w[:, None], jnp.zeros((1, 9), x1.dtype)], axis=0
    )  # [2N+1, 9]
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    h = Vt[-1].reshape(3, 3)
    Hn = jnp.linalg.solve(T2, h @ T1)
    return Hn / jnp.where(jnp.abs(Hn[2, 2]) < 1e-10, 1e-10, Hn[2, 2])


def fundamental_symmetric_chi2(F21, x1, x2, sigma2: float):
    """Per-match symmetric epipolar chi-squares (chi1, chi2) like
    Initializer.cc CheckFundamental:425-533."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    l2 = x1h @ F21.T  # epipolar line in image 2: F21 @ x1
    l1 = x2h @ F21  # line in image 1: F21^T @ x2
    d2 = jnp.sum(l2 * x2h, axis=-1) ** 2 / jnp.maximum(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12
    )
    d1 = jnp.sum(l1 * x1h, axis=-1) ** 2 / jnp.maximum(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12
    )
    return d1 / sigma2, d2 / sigma2


def homography_symmetric_chi2(H21, x1, x2, sigma2: float):
    """Per-match symmetric transfer chi-squares (Initializer.cc:323-423)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, a):
        ah = jnp.concatenate([a, jnp.ones_like(a[..., :1])], axis=-1)
        b = ah @ H.T
        w = jnp.where(jnp.abs(b[..., 2]) < 1e-10, 1e-10, b[..., 2])
        return b[..., :2] / w[..., None]

    e12 = jnp.sum((transfer(H21, x1) - x2) ** 2, axis=-1)
    e21 = jnp.sum((transfer(H12, x2) - x1) ** 2, axis=-1)
    return e21 / sigma2, e12 / sigma2


def decompose_essential(E: jnp.ndarray):
    """E -> four (R, t) candidates, |t| = 1 (Initializer.cc DecomposeE:1034)."""
    U, _, Vt = jnp.linalg.svd(E)
    # make proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def check_rt(R, t, x1, x2, mask, K1, K2, sigma2: float, th_chi2: float = 3.84,
             min_parallax_cos: float = 0.99998):
    """Count cheirality+reprojection-valid points for one (R,t) hypothesis.

    Mirrors Initializer.cc CheckRT:913-1031: triangulate each match, accept
    if finite, positive depth in both views, parallax cos < threshold and
    reprojection chi2 < th in both images.  Returns (ngood [scalar],
    good mask [N], parallax cos 50th-best, points3d [N,3]).
    """
    P1 = K1 @ jnp.concatenate([jnp.eye(3, dtype=R.dtype), jnp.zeros((3, 1), R.dtype)], 1)
    P2 = K2 @ jnp.concatenate([R, t[:, None]], axis=1)
    X = triangulate_dlt_batch(P1, P2, x1, x2)  # [N,3]
    finite = jnp.all(jnp.isfinite(X), axis=-1)

    # parallax between rays from the two camera centers
    C1 = jnp.zeros(3, R.dtype)
    C2 = -R.T @ t
    r1 = X - C1
    r2 = X - C2
    cosp = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
    )

    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]

    def reproj_chi2(P, X, x):
        Xh = jnp.concatenate([X, jnp.ones_like(X[:, :1])], axis=1)
        p = Xh @ P.T
        w = jnp.where(jnp.abs(p[:, 2]) < 1e-10, 1e-10, p[:, 2])
        return jnp.sum((p[:, :2] / w[:, None] - x) ** 2, axis=-1) / sigma2

    c1 = reproj_chi2(P1, X, x1)
    c2 = reproj_chi2(P2, X, x2)

    good = (
        mask
        & finite
        & (cosp < min_parallax_cos)
        & (z1 > 0)
        & (z2 > 0)
        & (c1 < th_chi2 * 4.0)
        & (c2 < th_chi2 * 4.0)
    )
    ngood = jnp.sum(good)
    # parallax statistic: like ref, take the 50th smallest cos among good (or best)
    cos_sorted = jnp.sort(jnp.where(good, cosp, 1.0))
    idx = jnp.minimum(49, jnp.maximum(ngood - 1, 0))
    parallax_cos = cos_sorted[idx]
    return ngood, good, parallax_cos, X
