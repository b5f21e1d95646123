"""Example driver: monocular SLAM on a synthetic blob-scene sequence.

The counterpart of the reference's Examples/Monocular/mono_tum.cc driver
loop (load frames, feed System, time it, dump trajectory + ATE) with the
dataset replaced by the built-in synthetic renderer (no datasets ship in
this environment).

Usage: python examples/run_synthetic.py [n_frames] [--free] [--verbose]

--free runs the zero-read FreeRunner pipeline (pipeline/device_loop.py)
instead of the synchronous System; the trajectory/ATE report is
identical in shape.  The trajectory is written to synthetic_traj.txt in
the current directory.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation, synthetic, trajectory
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System


def main(n_frames: int = 40):
    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                             width=320, height=240)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(n_frames, step=0.06)

    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=64, max_mp=8192,
                     max_frames_between_kf=8, init_min_matches=60,
                     verbose='--verbose' in sys.argv,
                     enable_fuse='--fuse' in sys.argv,
                     enable_cull='--no-cull' not in sys.argv,
                     enable_local_ba='--no-ba' not in sys.argv)

    if '--free' in sys.argv:
        from orb_slam2_annotate_tpu.pipeline.device_loop import FreeRunner

        runner = FreeRunner(cam, cfg, max_frames=n_frames)
        frames = [np.clip(scene.render(cam, R, t, h=240, w=320)[0],
                          0, 255).astype(np.uint8) for R, t in poses]
        runner.warmup()
        t0 = time.time()
        for k, img in enumerate(frames):
            runner.track_mono(img, k / 30.0)
        runner.block()
        dt = time.time() - t0
        out = runner.finish()
        traj = dict(out["trajectory"])
        ids = [k for k, T in traj.items() if T is not None]
        est_c = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
        gt_c = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
        rmse, _ = evaluation.ate_rmse(est_c, gt_c, with_scale=True)
        trajectory.save_tum("synthetic_traj.txt",
                            [(k / 30.0, traj[k]) for k in ids])
        print(f"free-running: {n_frames} frames in {dt:.3f}s "
              f"({n_frames/dt:.1f} fps), tracked {len(ids)}, "
              f"{out['n_keyframes']} keyframes, "
              f"{out['n_loops_closed']} loops")
        print(f"ATE RMSE (Sim3-aligned): {rmse*100:.2f} cm")
        return rmse, len(ids)

    slam = System(cam, cfg)

    times = []
    for k, (R, t) in enumerate(poses):
        img, _ = scene.render(cam, R, t, h=240, w=320)
        t0 = time.time()
        T = slam.track_mono(img, k / 30.0)
        times.append(time.time() - t0)
        status = "ok" if T is not None else slam.state
        print(f"frame {k:3d}  {status:>16s}  kf={slam.n_keyframes:3d} "
              f"mp={slam.n_mappoints:5d}  {times[-1]*1e3:7.1f} ms")

    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    est_c = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt_c = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
    rmse, _ = evaluation.ate_rmse(est_c, gt_c, with_scale=True)

    trajectory.save_tum("synthetic_traj.txt",
                        [(k / 30.0, traj[k]) for k in ids])
    med = np.median(times[5:]) if len(times) > 5 else np.median(times)
    print(f"\ntracked {len(ids)}/{n_frames} frames, "
          f"{slam.n_keyframes} keyframes, {slam.n_mappoints} map points")
    print(f"ATE RMSE (Sim3-aligned): {rmse*100:.2f} cm over "
          f"{np.linalg.norm(gt_c[-1]-gt_c[0]):.2f} m trajectory")
    print(f"median frame time: {med*1e3:.1f} ms "
          f"(first frames include XLA compilation)")
    print("trajectory written to synthetic_traj.txt")
    return rmse, len(ids)


if __name__ == "__main__":
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(pos[0]) if pos else 40
    rmse, n_ok = main(n)
    assert n_ok > 0.6 * n, f"tracked only {n_ok}/{n}"
    assert rmse < 0.10, f"ATE {rmse}"
    print("OK")
