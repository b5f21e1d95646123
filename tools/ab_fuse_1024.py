"""Fuse A/B + StructuredScene measurement AT THE BENCH OPERATING POINT
(VGA, 1024 features, 8 levels — VERDICT r3 item 4: the r3 fuse A/B and
vocab decisions were measured at 512f/4L while the shipped benchmark
runs 1024f/8L).

Runs the free path (the benchmarked production path) with
enable_fuse off/on over multiple seeds on PlaneScene (mono + RGB-D) and
reports mean ATE, plus StructuredScene tracked fraction at 1024f.

    python tools/ab_fuse_1024.py            # on the GPU
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def run_one(scene, poses, cam, sensor, fuse, n_frames):
    from orb_slam2_annotate_tpu.io import evaluation
    from orb_slam2_annotate_tpu.pipeline import SlamConfig
    from orb_slam2_annotate_tpu.pipeline.device_loop import FreeRunner

    cfg = SlamConfig(
        sensor=sensor, n_features=1024, n_levels=8,
        max_kf=128, max_mp=16384, max_frames_between_kf=6,
        init_min_matches=60, enable_loop_closing=False,
        enable_fuse=fuse, th_depth=100.0 if sensor != "mono" else 40.0)
    r = FreeRunner(cam, cfg, max_frames=n_frames, auto_grow=False)
    for k, (R, t) in enumerate(poses):
        img, dep = scene.render(cam, R, t)
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        if sensor == "rgbd":
            r.track_rgbd(u8, dep.astype(np.float32), k / 30.0)
        else:
            r.track_mono(u8, k / 30.0)
    out = r.finish()
    tr = [(k, T) for k, T in out["trajectory"] if T is not None]
    if len(tr) < 8:
        return None, len(tr)
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in tr])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k, _ in tr])
    ate, _ = evaluation.ate_rmse(est, gt, with_scale=(sensor == "mono"))
    return float(ate), len(tr)


def main():
    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.io import synthetic

    n = 48
    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                             width=640, height=480, bf=500.0 * 0.08)
    poses = synthetic.orbit_trajectory(n, step=0.05)
    res = {"config": "VGA 1024f/8L free path", "mono": {}, "rgbd": {},
           "structured": {}}
    for fuse in (False, True):
        key = "fuse_on" if fuse else "fuse_off"
        ates = []
        for seed in range(6):
            scene = synthetic.PlaneScene(seed=seed)
            ate, ntr = run_one(scene, poses, cam, "mono", fuse, n)
            print(f"mono {key} seed={seed}: ate="
                  f"{ate if ate is None else round(ate * 100, 2)}cm "
                  f"tracked={ntr}", file=sys.stderr)
            if ate is not None:
                ates.append(ate)
        res["mono"][key] = dict(
            mean_ate_cm=round(1e2 * float(np.mean(ates)), 2) if ates else None,
            n_ok=len(ates))
        ates = []
        for seed in range(4):
            scene = synthetic.PlaneScene(seed=10 + seed)
            ate, ntr = run_one(scene, poses, cam, "rgbd", fuse, n)
            print(f"rgbd {key} seed={seed}: ate="
                  f"{ate if ate is None else round(ate * 100, 2)}cm "
                  f"tracked={ntr}", file=sys.stderr)
            if ate is not None:
                ates.append(ate)
        res["rgbd"][key] = dict(
            mean_ate_cm=round(1e2 * float(np.mean(ates)), 2) if ates else None,
            n_ok=len(ates))
        # StructuredScene: tracked fraction at the 1024f operating point
        # (r3: 32/40 at 512f; target >= 95%)
        trs, ates = [], []
        for seed in range(3):
            scene = synthetic.StructuredScene(seed=seed)
            ate, ntr = run_one(scene, poses, cam, "mono", fuse, n)
            print(f"structured {key} seed={seed}: ate="
                  f"{ate if ate is None else round(ate * 100, 2)}cm "
                  f"tracked={ntr}/{n}", file=sys.stderr)
            trs.append(ntr)
            if ate is not None:
                ates.append(ate)
        res["structured"][key] = dict(
            tracked=trs, n_frames=n,
            mean_ate_cm=round(1e2 * float(np.mean(ates)), 2) if ates else None)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
