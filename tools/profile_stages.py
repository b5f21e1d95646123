"""Stage-level micro-profiling on the accelerator: which device programs
inside track_frame and the keyframe chain dominate their cost.

Usage: python tools/profile_stages.py
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
    from orb_slam2_annotate_tpu.pipeline.frame import make_frame_mono
    from orb_slam2_annotate_tpu.pipeline import tracking as tk
    from orb_slam2_annotate_tpu.pipeline import local_mapping as lm
    from orb_slam2_annotate_tpu.solvers import pose_opt
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
    for k in range(24):
        slam.track_mono(frames[k], k / 30.0)
    slam.flush()
    print(f"state={slam.state} kfs={slam.n_keyframes} mps={slam.n_mappoints}")

    fr = make_frame_mono(jnp.asarray(frames[24]), cam, cfg.extractor)
    jax.block_until_ready(fr.desc)
    m = slam.map
    R, t = slam.R, slam.t
    vel_R, vel_t = slam.vel if slam.vel is not None else (jnp.eye(3), jnp.zeros(3))
    obs = slam.last_obs

    # --- full fused step
    def full():
        return tk.track_frame(cam, m, fr, slam.last_frame, obs, R, t,
                              vel_R, vel_t, jnp.asarray(True),
                              jnp.asarray(slam.ref_kf, jnp.int32)).stats
    print(f"track_frame fused        : {timeit(full)*1e3:8.2f} ms")

    # --- motion model alone
    def mm():
        return tk.track_with_motion_model(cam, m, fr, slam.last_frame, obs,
                                          R, t)[3]
    print(f"  track_with_motion_model: {timeit(mm)*1e3:8.2f} ms")

    # --- local map alone
    def lmt():
        return tk.track_local_map(cam, m, fr, R, t, obs).n_inliers
    print(f"  track_local_map        : {timeit(lmt)*1e3:8.2f} ms")

    # --- pose_opt alone (1024 obs)
    pobs = tk._pose_obs_from_obs(m, fr, obs)
    po = jax.jit(lambda R0, t0: pose_opt.optimize_pose(cam, R0, t0, pobs)[3])
    print(f"  pose_opt 4x10          : {timeit(lambda: po(R, t))*1e3:8.2f} ms")

    # --- pose_opt 1 round of 10
    po1 = jax.jit(lambda R0, t0: pose_opt.optimize_pose(cam, R0, t0, pobs,
                                                        rounds=1)[3])
    print(f"  pose_opt 1x10          : {timeit(lambda: po1(R, t))*1e3:8.2f} ms")

    # --- 6x6 solve in a scan x40
    H = jnp.eye(6) * 100.0 + jax.random.normal(jax.random.PRNGKey(0), (6, 6))
    H = H @ H.T
    g = jnp.ones(6)

    @jax.jit
    def solve_scan(H, g):
        def step(c, _):
            return c + jnp.linalg.solve(H + c[0] * jnp.eye(6), g), None
        out, _ = jax.lax.scan(step, g, None, length=40)
        return out
    print(f"  40x seq 6x6 solve      : {timeit(lambda: solve_scan(H, g))*1e3:8.2f} ms")

    # --- matching alone
    from orb_slam2_annotate_tpu.ops import matching
    uvp = fr.xy
    pvalid = fr.valid

    sm_j = jax.jit(lambda a, b, c, d, e, f: matching.search_frame_to_frame(
        a, b, c, d, e, f).idx)

    def sm():
        return sm_j(fr, slam.last_frame, uvp, pvalid, slam.last_frame.octave,
                    jnp.full((fr.xy.shape[0],), 15.0))
    print(f"  search_frame_to_frame  : {timeit(sm)*1e3:8.2f} ms")

    # --- observation matrix / covisibility
    cov = jax.jit(lambda mm_: ms.covisibility(mm_))
    print(f"  covisibility [K,P]     : {timeit(lambda: cov(m))*1e3:8.2f} ms")

    # --- keyframe chain pieces
    slot = jnp.asarray(slam.ref_kf)
    def cnm():
        return lm.create_new_mappoints(m, cam, slot, update_stats=False).mp_pos
    print(f"  create_new_mappoints   : {timeit(cnm, n=10)*1e3:8.2f} ms")

    def lba():
        # local_bundle_adjustment donates its input map: pass a fresh copy
        mc = jax.tree.map(jnp.copy, m)
        return lm.local_bundle_adjustment(mc, cam, slot,
                                          update_stats=False).map.kf_R
    print(f"  local_BA (7+10 iters)  : {timeit(lba, n=10)*1e3:8.2f} ms")

    def cull():
        return lm.cull_keyframes(m, slot, update_stats=False)[1].slots
    print(f"  cull_keyframes         : {timeit(cull, n=10)*1e3:8.2f} ms")

    def stats():
        return ms.update_mappoint_stats(m).mp_desc
    print(f"  update_mappoint_stats  : {timeit(stats, n=10)*1e3:8.2f} ms")

    from orb_slam2_annotate_tpu.pipeline.loop_closing import detect_loop_device
    lc = slam.loop_closer
    def det():
        return detect_loop_device(lc.vocab, lc.db.bows, m, slot, 3).cands
    print(f"  detect_loop_device     : {timeit(det, n=10)*1e3:8.2f} ms")

    import time as _t
    t0 = _t.perf_counter()
    for k in range(24, 40):
        slam.track_mono(frames[k], k / 30.0)
    slam.flush()
    dt = _t.perf_counter() - t0
    print(f"steady loop 16 frames    : {dt:6.2f} s ({16/dt:.1f} fps)")
    print(slam.telemetry.report())


if __name__ == "__main__":
    main()
