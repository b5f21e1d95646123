"""Monocular two-view bootstrap: batched H/F RANSAC + model selection.

Replaces Initializer.cc end-to-end.  Where the reference fits H and F in
two parallel std::threads over 200 sequential RANSAC iterations each
(Initializer.cc:88-131), here ALL hypotheses for BOTH models are one
batched computation: sample [S,8] match subsets with jax.random, fit
S homographies and S fundamentals with vmapped eigen-solves, score all
S x N residuals as one matrix, pick the best of each, then apply the
reference's RH = SH/(SH+SF) > 0.40 model-selection rule and reconstruct
R|t (+ triangulated points) from the winner.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import twoview
from ..geometry.camera import CameraModel

TH_F = 3.841   # chi2 95%, 1 dof (Initializer.cc:437)
TH_H = 5.991   # chi2 95%, 2 dof (Initializer.cc:337)
SCORE_GAMMA_F = 5.991  # F scoring offset (Initializer.cc:435 thScore)


class InitResult(NamedTuple):
    success: jnp.ndarray    # bool
    used_homography: jnp.ndarray  # bool
    R: jnp.ndarray          # [3,3] cam2<-cam1 (frame1 is identity/world)
    t: jnp.ndarray          # [3] unit-norm baseline
    points: jnp.ndarray     # [N,3] triangulated in frame-1 coords
    good: jnp.ndarray       # [N] bool triangulation-valid matches
    n_good: jnp.ndarray     # i32


@partial(jax.jit, static_argnums=(4,))
def initialize_two_view(key, x1, x2, match_mask, n_ransac: int = 200,
                        sigma: float = 1.0, K: jnp.ndarray | None = None,
                        min_parallax_deg: float = 1.0, min_triangulated: int = 50):
    """Try to initialize from matched (undistorted) pixel pairs.

    x1, x2: [N,2]; match_mask: [N] bool.  K: [3,3] intrinsics.
    Returns InitResult.  The caller decides what to do on failure
    (reference deletes and recreates the Initializer, Tracking.cc:632).
    """
    N = x1.shape[0]
    sigma2 = sigma * sigma

    # --- sample S minimal sets of 8 valid matches
    probs = match_mask.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    keys = jax.random.split(key, n_ransac)
    samples = jax.vmap(
        lambda k: jax.random.choice(k, N, (8,), replace=False, p=probs)
    )(keys)  # [S, 8]

    s_x1 = x1[samples]  # [S,8,2]
    s_x2 = x2[samples]

    # --- fit all hypotheses (vmapped small eigendecompositions)
    Fs = jax.vmap(twoview.fit_fundamental_8pt)(s_x1, s_x2)  # [S,3,3]
    Hs = jax.vmap(twoview.fit_homography_dlt)(s_x1, s_x2)

    # --- score all hypotheses against all matches
    def sf(F):
        c1, c2 = twoview.fundamental_symmetric_chi2(F, x1, x2, sigma2)
        in1, in2 = c1 < TH_F, c2 < TH_F
        s = jnp.where(in1 & match_mask, SCORE_GAMMA_F - c1, 0.0) + jnp.where(
            in2 & match_mask, SCORE_GAMMA_F - c2, 0.0
        )
        return jnp.sum(s), in1 & in2 & match_mask

    def sh(H):
        c1, c2 = twoview.homography_symmetric_chi2(H, x1, x2, sigma2)
        in1, in2 = c1 < TH_H, c2 < TH_H
        s = jnp.where(in1 & match_mask, TH_H - c1, 0.0) + jnp.where(
            in2 & match_mask, TH_H - c2, 0.0
        )
        return jnp.sum(s), in1 & in2 & match_mask

    scores_f, inls_f = jax.vmap(sf)(Fs)
    scores_h, inls_h = jax.vmap(sh)(Hs)

    bf = jnp.argmax(scores_f)
    bh = jnp.argmax(scores_h)
    SF, SH = scores_f[bf], scores_h[bh]
    F_best, F_inl = Fs[bf], inls_f[bf]
    H_best, H_inl = Hs[bh], inls_h[bh]

    # least-squares refit on all inliers (tightens the minimal-set model
    # before reconstruction; the reference keeps the RANSAC model but runs
    # in double precision — in f32 the refit is what restores the digits)
    F_best = twoview.fit_fundamental_8pt(x1, x2, F_inl)
    _, F_inl = sf(F_best)
    H_best = twoview.fit_homography_dlt(x1, x2, H_inl)
    _, H_inl = sh(H_best)

    use_h = SH / jnp.maximum(SH + SF, 1e-9) > 0.40  # Initializer.cc:124-131

    # --- reconstruct from F: E = K^T F K, 4 candidates, cheirality vote
    E = K.T @ F_best @ K
    Rs, ts = twoview.decompose_essential(E)

    def eval_rt(i):
        return twoview.check_rt(
            Rs[i], ts[i], x1, x2, F_inl, K, K, sigma2 * 4.0
        )

    ngoods, goods, parallaxes, Xs = jax.vmap(eval_rt)(jnp.arange(4))
    best_rt = jnp.argmax(ngoods)
    nG = ngoods[best_rt]
    # accept only with clear winner (Initializer.cc:585-650 semantics,
    # relaxed: winner must have 70% more good points than runner-up is the
    # ref's nsimilar<2 check)
    sorted_n = jnp.sort(ngoods)
    clear = sorted_n[-1].astype(jnp.float32) > 1.5 * jnp.maximum(
        sorted_n[-2].astype(jnp.float32), 1.0
    )
    enough = nG >= jnp.maximum(
        min_triangulated, (0.9 * jnp.sum(F_inl)).astype(jnp.int32)
    )
    parallax_ok = parallaxes[best_rt] < jnp.cos(jnp.deg2rad(min_parallax_deg))
    f_success = clear & enough & parallax_ok

    # --- reconstruct from H (Faugeras): the reference decomposes into 8
    # motions; a batch-simpler route with equal coverage: H inliers are a
    # plane — recover E from the same correspondences via the fundamental
    # fit restricted to H-inliers is degenerate, so use homography
    # decomposition through SVD (Faugeras'88, as ReconstructH:653).
    R_h, t_h, h_valid = _reconstruct_h(H_best, K, x1, x2, H_inl, sigma2)
    ngood_h, good_h, par_h, X_h = twoview.check_rt(
        R_h, t_h, x1, x2, H_inl, K, K, sigma2 * 4.0
    )
    h_success = (
        h_valid
        & (ngood_h >= jnp.maximum(min_triangulated,
                                  (0.9 * jnp.sum(H_inl)).astype(jnp.int32)))
        & (par_h < jnp.cos(jnp.deg2rad(min_parallax_deg)))
    )

    success = jnp.where(use_h, h_success, f_success)
    R = jnp.where(use_h, R_h, Rs[best_rt])
    t = jnp.where(use_h, t_h, ts[best_rt])
    X = jnp.where(use_h, X_h, Xs[best_rt])
    good = jnp.where(use_h, good_h, goods[best_rt])
    n_good = jnp.where(use_h, ngood_h, nG)
    return InitResult(success, use_h, R, t, X, good & match_mask, n_good)


def _reconstruct_h(H, K, x1, x2, inl, sigma2):
    """Faugeras homography decomposition: test the 8 (R, t, n) solutions by
    cheirality and keep the best (ReconstructH, Initializer.cc:653-826)."""
    A = jnp.linalg.inv(K) @ H @ K
    U, w, Vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    ok = (d1 / jnp.maximum(d2, 1e-9) > 1.00001) & (
        d2 / jnp.maximum(d3, 1e-9) > 1.00001
    )

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux_st = jnp.sqrt(
        jnp.maximum(
            (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0
        )
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)

    e1 = jnp.array([1.0, -1.0, 1.0, -1.0])
    e3 = jnp.array([1.0, -1.0, -1.0, 1.0])

    # d' > 0 branch (4 solutions)
    ctheta = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    Rs_p, ts_p, ns_p = [], [], []
    for i in range(4):
        x1v = e1[i] * aux1
        x3v = e3[i] * aux3
        st = e1[i] * e3[i] * aux_st
        Rp = jnp.array(
            [[ctheta, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ctheta]]
        )
        R = s * U @ Rp @ Vt
        tp = jnp.array([x1v, 0.0, -x3v]) * (d1 - d3)
        t = U @ tp
        Rs_p.append(R)
        ts_p.append(t / jnp.maximum(jnp.linalg.norm(t), 1e-12))

    # d' < 0 branch (4 solutions)
    cphi = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    aux_sp = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    for i in range(4):
        x1v = e1[i] * aux1
        x3v = e3[i] * aux3
        sp = e1[i] * e3[i] * aux_sp
        Rp = jnp.array(
            [[cphi, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cphi]]
        )
        R = s * U @ Rp @ Vt
        tp = jnp.array([x1v, 0.0, x3v]) * (d1 + d3)
        t = U @ tp
        Rs_p.append(R)
        ts_p.append(t / jnp.maximum(jnp.linalg.norm(t), 1e-12))

    Rs = jnp.stack(Rs_p)
    ts = jnp.stack(ts_p)

    def eval_rt(i):
        n, g, p, X = twoview.check_rt(Rs[i], ts[i], x1, x2, inl, K, K, sigma2 * 4.0)
        return n

    ns = jax.vmap(eval_rt)(jnp.arange(8))
    best = jnp.argmax(ns)
    # require clear winner like the ref (secondBest < 0.75 * best)
    srt = jnp.sort(ns)
    clear = srt[-2].astype(jnp.float32) < 0.75 * srt[-1].astype(jnp.float32)
    return Rs[best], ts[best], ok & clear
