"""Pipelined (async_depth > 0) tracking must match the synchronous path.

The async mode defers keyframe/LOST policy by up to async_depth frames so
the host never blocks on a device read (the analog of the
reference's tracking/LocalMapping thread decoupling, System.cc:91).  The
trajectory it produces on a clean sequence must be as accurate as the
synchronous mode's.
"""

import numpy as np
import pytest

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation, synthetic
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System

CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                         width=320, height=240)


@pytest.mark.slow
def test_async_matches_sync_accuracy():
    n_frames = 30
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(n_frames, step=0.06)
    frames = [scene.render(CAM, R, t, h=240, w=320)[0] for R, t in poses]

    def run(depth):
        cfg = SlamConfig(n_features=512, n_levels=4, max_kf=64, max_mp=8192,
                         max_frames_between_kf=8, init_min_matches=60,
                         async_depth=depth)
        slam = System(CAM, cfg)
        for k, img in enumerate(frames):
            slam.track_mono(img, k / 30.0)
        slam.flush()
        traj = dict(slam.frame_trajectory())
        ids = [k for k, T in traj.items() if T is not None]
        est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
        gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
        rmse, _ = evaluation.ate_rmse(est, gt, with_scale=True)
        return rmse, len(ids), slam

    rmse_async, n_async, slam = run(4)
    assert slam.state == "OK"
    assert n_async > 0.7 * n_frames, f"async tracked only {n_async}"
    assert len(slam.records) == n_frames  # every frame got a record
    fids = [r.frame_id for r in slam.records]
    assert fids == sorted(fids)           # in order, exactly once
    assert rmse_async < 0.35, f"async ATE {rmse_async:.3f} m"
