"""End-to-end monocular SLAM on a synthetic sequence with exact GT.

The analog of the reference's dataset-driven integration runs
(SURVEY §4): run the full pipeline (init -> tracking -> keyframes ->
triangulation -> local BA) and assert trajectory ATE after Sim3
alignment (mono scale is arbitrary).
"""

import numpy as np
import pytest

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation, synthetic
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System

CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                         width=320, height=240)


@pytest.mark.slow
def test_mono_synthetic_sequence():
    n_frames = 40
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(n_frames, step=0.06)

    cfg = SlamConfig(
        n_features=512, n_levels=4, max_kf=64, max_mp=8192,
        max_frames_between_kf=8, init_min_matches=60,
    )
    slam = System(CAM, cfg)
    # precompile path (the bench and production drivers call this; it
    # must leave the system state untouched)
    slam.warmup()
    assert slam.state == "NO_IMAGES" and slam.n_keyframes == 0

    est = {}
    for k, (R, t) in enumerate(poses):
        img, _ = scene.render(CAM, R, t, h=240, w=320)
        T = slam.track_mono(img, k / 30.0)
        if T is not None:
            est[k] = T

    assert slam.state == "OK", f"tracking state {slam.state}"
    assert slam.n_keyframes >= 3
    assert slam.n_mappoints > 100

    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    assert len(ids) > 0.7 * n_frames, f"only {len(ids)} tracked frames"

    # camera centers: est from Tcw, gt from poses
    est_c = []
    gt_c = []
    for k in ids:
        T = traj[k]
        est_c.append(-T[:3, :3].T @ T[:3, 3])
        R, t = poses[k]
        gt_c.append(-R.T @ t)
    est_c = np.stack(est_c)
    gt_c = np.stack(gt_c)

    rmse, _ = evaluation.ate_rmse(est_c, gt_c, with_scale=True)
    # cm-class accuracy: the velocity-extrapolation feedback loop on
    # weakly-observable pose modes was the drift driver (fixed by damped
    # velocity, tracking.py GAMMA_VEL); measured ~0.01 on this sweep
    assert rmse < 0.08, f"ATE RMSE {rmse:.4f} m"
