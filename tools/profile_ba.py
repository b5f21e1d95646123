"""Micro-profile of local BA internals on the accelerator: which part of an
LM iteration dominates — linearization (grid gathers + einsums), the
Schur reduction, or the dense [6C,6C] solve — and what the cheaper
structure ops (observation_table, covisibility) cost.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def timeit(fn, n=20, warmup=3):
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.io import synthetic
    from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
    from orb_slam2_annotate_tpu.pipeline import local_mapping as lm
    from orb_slam2_annotate_tpu.solvers import ba_core
    from orb_slam2_annotate_tpu.worldmap import map_state as ms

    print("devices:", jax.devices())
    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    cfg = SlamConfig(n_features=1024, max_kf=128, max_mp=16384,
                     max_frames_between_kf=6, init_min_matches=60)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(40, step=0.05)
    frames = [np.clip(scene.render(cam, R, t)[0], 0, 255).astype(np.uint8)
              for R, t in poses]
    slam = System(cam, cfg)
    for k in range(30):
        slam.track_mono(frames[k], k / 30.0)
    slam.flush()
    print(f"state={slam.state} kfs={slam.n_keyframes} mps={slam.n_mappoints}")
    m = slam.map
    slot = jnp.asarray(slam.ref_kf)

    # ---- structure ops
    O_j = jax.jit(ms.observation_matrix)
    print(f"observation_matrix [K,P] : {timeit(lambda: O_j(m))*1e3:8.2f} ms")
    tab_j = jax.jit(lambda mm: ms.observation_table(mm)[0])
    print(f"observation_table        : {timeit(lambda: tab_j(m))*1e3:8.2f} ms")
    cov_j = jax.jit(lambda mm: ms.covisibility(mm))
    print(f"covisibility full        : {timeit(lambda: cov_j(m))*1e3:8.2f} ms")

    # ---- build the same GridBA problem local_bundle_adjustment builds
    n_opt, n_fixed = 16, 16
    K, P, N = m.K, m.P, m.N
    W = ms.covisibility(m)
    w_slot = jnp.where(m.kf_valid, W[slot], -1).at[slot].set(-1)
    _, nb = jax.lax.top_k(w_slot, n_opt - 1)
    opt_kfs = jnp.concatenate([jnp.asarray([slot]), nb])
    opt_ok = jnp.concatenate([jnp.asarray([True]), w_slot[nb] > 0])
    O = ms.observation_matrix(m)
    opt_rows = O[opt_kfs] & opt_ok[:, None]
    pts_mask = jnp.any(opt_rows, axis=0) & m.mp_valid
    sees_local = (O.astype(jnp.float32) @ pts_mask.astype(jnp.float32)) > 0
    is_opt = jnp.zeros((K,), bool).at[opt_kfs].max(opt_ok)
    fixed_cand = sees_local & m.kf_valid & ~is_opt
    _, fx = jax.lax.top_k(fixed_cand.astype(jnp.int32), n_fixed)
    fx_ok = fixed_cand[fx]
    cams_all = jnp.concatenate([opt_kfs, fx])
    cams_ok = jnp.concatenate([opt_ok, fx_ok])
    cam_fixed = jnp.concatenate(
        [jnp.zeros((n_opt,), bool), jnp.ones((n_fixed,), bool)])
    P_BA = 2048
    _, psel = jax.lax.top_k(pts_mask.astype(jnp.int32), P_BA)
    psel_ok = pts_mask[psel]
    g2l = jnp.full((P,), -1, jnp.int32).at[psel].set(
        jnp.where(psel_ok, jnp.arange(P_BA, dtype=jnp.int32), -1))
    obs_grid = m.kf_obs[cams_all]
    feat_ok = m.kf_feat_valid[cams_all] & cams_ok[:, None]
    pt_loc = jnp.where(feat_ok & (obs_grid >= 0),
                       g2l[jnp.clip(obs_grid, 0)], -1)
    e_valid = feat_ok & (pt_loc >= 0)
    octv = m.kf_octave[cams_all]
    inv_s2 = 1.0 / (1.2 ** (2.0 * octv.astype(jnp.float32)))
    g = ba_core.GridBA(
        R=m.kf_R[cams_all], t=m.kf_t[cams_all], points=m.mp_pos[psel],
        cam_fixed=cam_fixed | ~cams_ok, cam_valid=cams_ok, pt_valid=psel_ok,
        pt_loc=pt_loc.astype(jnp.int32), uv=m.kf_xy[cams_all],
        ur=m.kf_ur[cams_all], inv_sigma2=inv_s2, edge_valid=e_valid)
    g = jax.tree.map(jnp.asarray, g)
    jax.block_until_ready(g.R)
    print(f"n_edges={int(jnp.sum(e_valid))} n_pts={int(jnp.sum(psel_ok))} "
          f"n_cams={int(jnp.sum(cams_ok))}")

    for it in (1, 2, 5, 13):
        f = jax.jit(lambda gg, i=it: ba_core.bundle_adjust_grid(
            cam, gg, iters=i, robust=True)[4])
        print(f"bundle_adjust_grid it={it:2d}: "
              f"{timeit(lambda: f(g), n=10)*1e3:8.2f} ms")

    # ---- pieces of one iteration
    C, N_ = g.pt_loc.shape
    base_valid = g.edge_valid & (g.pt_loc >= 0)
    cam_ids = jnp.broadcast_to(jnp.arange(C)[:, None], (C, N_))
    n_ids = jnp.broadcast_to(jnp.arange(N_)[None, :], (C, N_))
    inv = jnp.full((P_BA, C), N_, jnp.int32).at[
        jnp.clip(g.pt_loc, 0).reshape(-1), cam_ids.reshape(-1)
    ].min(jnp.where(base_valid, n_ids, N_).reshape(-1))
    jax.block_until_ready(inv)

    def pad_n(a):
        pad_width = [(0, 0), (0, 1)] + [(0, 0)] * (a.ndim - 2)
        return jnp.pad(a, pad_width)

    lin_sel_base = jnp.arange(C)[None, :] * (N_ + 1)

    @jax.jit
    def linearize_only(R, t, X):
        r, Jc, Jp, is_stereo, depth_ok = ba_core._grid_residual_jac(
            cam, R, t, X, g)
        chi2 = jnp.sum(r * r, axis=-1) * g.inv_sigma2
        delta2 = jnp.where(is_stereo, ba_core.CHI2_STEREO, ba_core.CHI2_MONO)
        w_huber = jnp.where(chi2 > delta2,
                            jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)), 1.0)
        live = base_valid & depth_ok
        w = g.inv_sigma2 * w_huber * live
        Jc = jnp.where(g.cam_fixed[:, None, None, None], 0.0, Jc)
        Jcw = Jc * w[..., None, None]
        Jpw = Jp * w[..., None, None]
        Hcc = jnp.einsum("cnij,cnik->cjk", Jcw, Jc)
        gc = jnp.einsum("cnij,cni->cj", Jcw, r)
        sel = inv + lin_sel_base

        def take(a):
            return pad_n(a).reshape((C * (N_ + 1),) + a.shape[2:])[sel]

        Jp_pc = take(Jpw)
        Jp0_pc = take(Jp)
        Jcw_pc = take(Jcw)
        r_pc = take(r)
        Hpp = jnp.einsum("pcij,pcik->pjk", Jp_pc, Jp0_pc)
        gp = jnp.einsum("pcij,pci->pj", Jp_pc, r_pc)
        B = jnp.einsum("pcij,pcik->pcjk", Jcw_pc, Jp0_pc)
        return Hcc, Hpp, B, gc, gp

    out = linearize_only(g.R, g.t, g.points)
    jax.block_until_ready(out[0])
    print(f"  linearize only         : "
          f"{timeit(lambda: linearize_only(g.R, g.t, g.points))*1e3:8.2f} ms")
    Hcc, Hpp, B, gc, gp = out
    cam_free = g.cam_valid & ~g.cam_fixed

    solve_j = jax.jit(lambda: ba_core.schur_solve_dense(
        Hcc, Hpp, B, gc, gp, 1e-4, cam_free)[0])
    print(f"  schur_solve_dense x1   : {timeit(solve_j)*1e3:8.2f} ms")

    solve3_j = jax.jit(lambda: jax.vmap(
        lambda l: ba_core.schur_solve_dense(Hcc, Hpp, B, gc, gp, l, cam_free)[0]
    )(jnp.asarray([1e-4, 8e-4, 64e-4])))
    print(f"  schur_solve_dense x3   : {timeit(solve3_j)*1e3:8.2f} ms")

    # the dense [6C,6C] factorization alone
    from orb_slam2_annotate_tpu.geometry.smallsolve import inv3
    Hpp_d = Hpp + 1e-3 * jnp.eye(3)
    Hpp_inv = inv3(Hpp_d)
    BH = jnp.einsum("pcij,pjk->pcik", B, Hpp_inv)
    S_off = jnp.einsum("pcik,pdlk->cdil", BH, B)
    S = -S_off
    S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc + 1e-3 * jnp.eye(6))
    Sf = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    Sf = Sf + 200.0 * jnp.eye(C * 6)
    rf = jnp.ones(C * 6)
    jax.block_until_ready(Sf)
    chol_j = jax.jit(lambda A, b: jax.scipy.linalg.solve(A, b, assume_a="pos"))
    print(f"  [192,192] chol solve   : {timeit(lambda: chol_j(Sf, rf))*1e3:8.2f} ms")
    lu_j = jax.jit(lambda A, b: jnp.linalg.solve(A, b))
    print(f"  [192,192] LU solve     : {timeit(lambda: lu_j(Sf, rf))*1e3:8.2f} ms")

    @jax.jit
    def schur_reduce_only():
        Hpp_inv = inv3(Hpp + 1e-3 * jnp.eye(3))
        BH = jnp.einsum("pcij,pjk->pcik", B, Hpp_inv)
        S_off = jnp.einsum("pcik,pdlk->cdil", BH, B)
        rhs = -gc + jnp.einsum("pcik,pk->ci", BH, gp)
        return S_off, rhs
    print(f"  schur reduce (B HppI B): {timeit(lambda: schur_reduce_only()[1])*1e3:8.2f} ms")

    # ---- cull pieces
    def cull():
        return lm.cull_keyframes(m, slot, update_stats=False)[1].slots
    print(f"cull_keyframes           : {timeit(cull, n=10)*1e3:8.2f} ms")

    def stats_t():
        return ms.update_mappoint_stats_touched(
            m, lm.window_touched_points(m, slot)).mp_desc
    print(f"stats touched+window     : {timeit(stats_t, n=10)*1e3:8.2f} ms")

    def tri():
        return lm.create_new_mappoints(m, cam, slot, update_stats=False).mp_pos
    print(f"create_new_mappoints     : {timeit(tri, n=10)*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
