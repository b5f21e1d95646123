"""Driver fixture tests (VERDICT r2 item 6): the dataset drivers
(examples/run_tum.py, run_kitti.py) must EXECUTE end-to-end from
on-disk fixtures — no network datasets exist in this environment, so
tiny TUM-layout / KITTI-layout sequences are written from the synthetic
renderer and the drivers run as subprocesses, exactly like a user
invoking them (mono_tum.cc:36-124 analog), then their trajectory
outputs are re-parsed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest


def _write_png(path, img):
    import matplotlib.image as mpimg

    mpimg.imsave(path, np.clip(img, 0, 255).astype(np.uint8),
                 cmap="gray", vmin=0, vmax=255)


SETTINGS_YAML = """%YAML:1.0
Camera.fx: 250.0
Camera.fy: 250.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.fps: 30.0
Camera.bf: 20.0
Camera.RGB: 1
Camera.width: 320
Camera.height: 240
ThDepth: 100.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _render_frames(n):
    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.io import synthetic

    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                             width=320, height=240)
    scene = synthetic.PlaneScene(seed=9)
    poses = synthetic.orbit_trajectory(n, step=0.06)
    return [scene.render(cam, R, t, h=240, w=320)[0] for R, t in poses]


def _run_driver(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                      capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, f"driver failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
    return r


@pytest.mark.slow
def test_run_tum_mono_from_fixture(tmp_path):
    n = 16
    frames = _render_frames(n)
    seq = tmp_path / "tum_seq"
    (seq / "rgb").mkdir(parents=True)
    with open(seq / "rgb.txt", "w") as f:
        f.write("# color images\n")
        for k, img in enumerate(frames):
            rel = f"rgb/{k:04d}.png"
            _write_png(str(seq / rel), img)
            f.write(f"{k / 30.0:.6f} {rel}\n")
    with open(tmp_path / "settings.yaml", "w") as f:
        f.write(SETTINGS_YAML)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _run_driver([os.path.join(repo, "examples", "run_tum.py"), "mono",
                 str(tmp_path / "settings.yaml"), str(seq)],
                cwd=str(tmp_path))

    # outputs exist and re-parse in TUM format
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt"):
        rows = np.loadtxt(str(tmp_path / name))
        assert rows.ndim == 2 and rows.shape[1] == 8, name
        q = rows[:, 4:8]
        assert np.allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-3)
    assert np.loadtxt(str(tmp_path / "KeyFrameTrajectory.txt")).shape[0] >= 2


@pytest.mark.slow
def test_run_kitti_mono_from_fixture(tmp_path):
    n = 16
    frames = _render_frames(n)
    seq = tmp_path / "kitti_seq"
    (seq / "image_0").mkdir(parents=True)
    for k, img in enumerate(frames):
        _write_png(str(seq / "image_0" / f"{k:06d}.png"), img)
    with open(seq / "times.txt", "w") as f:
        for k in range(n):
            f.write(f"{k / 10.0:.6e}\n")
    with open(tmp_path / "settings.yaml", "w") as f:
        f.write(SETTINGS_YAML)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _run_driver([os.path.join(repo, "examples", "run_kitti.py"), "mono",
                 str(tmp_path / "settings.yaml"), str(seq)],
                cwd=str(tmp_path))

    # KITTI format: 12 columns (3x4 row-major), one row per frame
    rows = np.loadtxt(str(tmp_path / "CameraTrajectory.txt"))
    assert rows.ndim == 2 and rows.shape[1] == 12
    R0 = rows[-1].reshape(3, 4)[:, :3]
    assert abs(np.linalg.det(R0) - 1.0) < 1e-2


def test_load_image_gray_without_cv2(tmp_path, monkeypatch):
    """The pure-Python decode path must work when cv2 is absent."""
    import builtins

    from orb_slam2_annotate_tpu.io import datasets

    img = (np.random.RandomState(0).rand(24, 32) * 255).astype(np.uint8)
    _write_png(str(tmp_path / "x.png"), img)

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 disabled for test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    out = datasets.load_image_gray(str(tmp_path / "x.png"))
    assert out.shape == (24, 32)
    assert float(np.abs(out - img).max()) <= 2.0


@pytest.mark.slow
def test_run_euroc_mono_from_fixture(tmp_path):
    """EuRoC mav0 layout: cam0/data/<ns>.png + a timestamp list file
    (mono_euroc.cc LoadImages)."""
    n = 16
    frames = _render_frames(n)
    seq = tmp_path / "mav0"
    (seq / "cam0" / "data").mkdir(parents=True)
    ts_lines = []
    for k, img in enumerate(frames):
        ns = str(1403636579763555584 + k * 50_000_000)  # ~20 Hz in ns
        _write_png(str(seq / "cam0" / "data" / f"{ns}.png"), img)
        ts_lines.append(ns)
    with open(tmp_path / "timestamps.txt", "w") as f:
        f.write("\n".join(ts_lines) + "\n")
    with open(tmp_path / "settings.yaml", "w") as f:
        f.write(SETTINGS_YAML)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _run_driver([os.path.join(repo, "examples", "run_euroc.py"), "mono",
                 str(tmp_path / "settings.yaml"), str(seq),
                 str(tmp_path / "timestamps.txt")],
                cwd=str(tmp_path))

    rows = np.loadtxt(str(tmp_path / "CameraTrajectory.txt"))
    assert rows.ndim == 2 and rows.shape[1] == 8
    q = rows[:, 4:8]
    assert np.allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-3)


def _distorted_capture(img, cam_d):
    """Synthesize what a distorted-lens camera captures, from a pinhole
    render of the same pose: a scene ray at normalized x lands at
    K*distort(x) in the real camera, so raw(y) = pinhole(undistort(y))."""
    import jax.numpy as jnp

    from orb_slam2_annotate_tpu.geometry.camera import undistort_pixels
    from orb_slam2_annotate_tpu.geometry.rectify import remap_bilinear

    h, w = img.shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    grid = np.stack([u, v], -1).reshape(-1, 2)
    src = np.asarray(undistort_pixels(cam_d, jnp.asarray(grid)))
    src = src.reshape(h, w, 2)
    return np.asarray(remap_bilinear(jnp.asarray(img, jnp.float32),
                                     jnp.asarray(src)))


def _ate_vs_gt(traj_path, gt_by_ts, rate=30.0):
    from orb_slam2_annotate_tpu.io import evaluation

    rows = np.loadtxt(traj_path)
    assert rows.ndim == 2 and rows.shape[0] >= 8, "too few tracked frames"
    est, gt = [], []
    for r in rows:
        k = int(round(r[0] * rate))
        if k in gt_by_ts:
            est.append(r[1:4])
            gt.append(gt_by_ts[k])
    assert len(est) >= 8
    return evaluation.ate_rmse(np.stack(est), np.stack(gt),
                               with_scale=True)[0], len(est)


DISTORT_YAML = """%YAML:1.0
Camera.fx: 250.0
Camera.fy: 250.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: -0.15
Camera.k2: 0.03
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.fps: 30.0
Camera.bf: 20.0
Camera.RGB: 1
Camera.width: 320
Camera.height: 240
ThDepth: 100.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


@pytest.mark.slow
def test_run_tum_mono_distorted_fixture(tmp_path):
    """Nonzero k1/k2 end-to-end (VERDICT r3 item 7): frames are warped
    through the radial distortion model before hitting disk; the driver
    reads Camera.k1/k2 from YAML and the Frame build undistorts the
    keypoints (Frame.cc:443-475 analog).  ATE asserted against ground
    truth — a pipeline that ignored the distortion would blow the bound
    (~6-10 px of radial displacement at the image border)."""
    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.io import synthetic

    n = 20
    cam_pin = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                                 width=320, height=240)
    cam_d = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                               k1=-0.15, k2=0.03, width=320, height=240)
    scene = synthetic.PlaneScene(seed=9)
    poses = synthetic.orbit_trajectory(n, step=0.06)

    seq = tmp_path / "tum_seq"
    (seq / "rgb").mkdir(parents=True)
    gt_by_ts = {}
    with open(seq / "rgb.txt", "w") as f:
        f.write("# distorted color images\n")
        for k, (R, t) in enumerate(poses):
            img, _ = scene.render(cam_pin, R, t, h=240, w=320)
            raw = _distorted_capture(img, cam_d)
            rel = f"rgb/{k:04d}.png"
            _write_png(str(seq / rel), raw)
            f.write(f"{k / 30.0:.6f} {rel}\n")
            gt_by_ts[k] = -R.T @ t
    with open(tmp_path / "settings.yaml", "w") as f:
        f.write(DISTORT_YAML)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _run_driver([os.path.join(repo, "examples", "run_tum.py"), "mono",
                 str(tmp_path / "settings.yaml"), str(seq)],
                cwd=str(tmp_path))
    ate, n_est = _ate_vs_gt(str(tmp_path / "CameraTrajectory.txt"), gt_by_ts)
    assert ate < 0.12, f"distorted-mono ATE {ate:.3f} m over {n_est} frames"


@pytest.mark.slow
def test_run_euroc_stereo_rectification_fixture(tmp_path):
    """EuRoC-layout STEREO fixture through the LEFT./RIGHT. K/D/R/P
    rectification blocks (VERDICT r3 item 7; stereo_euroc.cc:62-90 +
    Examples/Stereo/EuRoC.yaml): raw distorted, slightly-rotated pairs
    on disk; the driver rectifies on device and tracks.  ATE asserted."""
    import jax.numpy as jnp

    from orb_slam2_annotate_tpu.geometry import CameraModel, lie
    from orb_slam2_annotate_tpu.geometry.rectify import stereo_rectify
    from orb_slam2_annotate_tpu.io import synthetic

    n = 24
    h, w = 240, 320
    K = np.array([[250.0, 0, 160.0], [0, 250.0, 120.0], [0, 0, 1]])
    D_l = np.array([-0.15, 0.03, 0.0, 0.0, 0.0])
    D_r = np.array([-0.12, 0.02, 0.0, 0.0, 0.0])
    # right camera: 0.2 m to the right, yawed 0.6 deg (x2 = R x1 + t)
    R_rel = np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.010, 0.002])))
    t_rel = -R_rel @ np.array([0.2, 0.0, 0.0], np.float32)
    R1, R2, P1, P2, bf = stereo_rectify(K, D_l, K, D_r, R_rel, t_rel, h, w)

    def mat_yaml(name, M):
        M = np.asarray(M, np.float64)
        rows, cols = M.shape
        data = ", ".join(f"{v:.9f}" for v in M.reshape(-1))
        return (f"{name}:\n   rows: {rows}\n   cols: {cols}\n"
                f"   dt: d\n   data: [{data}]\n")

    yaml_text = f"""%YAML:1.0
Camera.fx: {P1[0, 0]:.6f}
Camera.fy: {P1[1, 1]:.6f}
Camera.cx: {P1[0, 2]:.6f}
Camera.cy: {P1[1, 2]:.6f}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.fps: 20.0
Camera.bf: {bf:.6f}
Camera.RGB: 1
Camera.width: {w}
Camera.height: {h}
ThDepth: 100.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
LEFT.height: {h}
LEFT.width: {w}
""" + (mat_yaml("LEFT.K", K) + mat_yaml("LEFT.D", D_l[None])
       + mat_yaml("LEFT.R", R1) + mat_yaml("LEFT.P", P1)
       + mat_yaml("RIGHT.K", K) + mat_yaml("RIGHT.D", D_r[None])
       + mat_yaml("RIGHT.R", R2) + mat_yaml("RIGHT.P", P2))

    cam_pin = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                                 width=w, height=h)
    cam_dl = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                                k1=D_l[0], k2=D_l[1], width=w, height=h)
    cam_dr = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                                k1=D_r[0], k2=D_r[1], width=w, height=h)
    scene = synthetic.PlaneScene(seed=9)
    poses = synthetic.orbit_trajectory(n, step=0.06)

    seq = tmp_path / "mav0"
    (seq / "cam0" / "data").mkdir(parents=True)
    (seq / "cam1" / "data").mkdir(parents=True)
    ts_lines = []
    gt = []
    for k, (R, t) in enumerate(poses):
        ns = str(1403636579763555584 + k * 50_000_000)
        img_l, _ = scene.render(cam_pin, R, t, h=h, w=w)
        R_r = R_rel @ R
        t_r = R_rel @ t + t_rel
        img_r, _ = scene.render(cam_pin, R_r, t_r, h=h, w=w)
        _write_png(str(seq / "cam0" / "data" / f"{ns}.png"),
                   _distorted_capture(img_l, cam_dl))
        _write_png(str(seq / "cam1" / "data" / f"{ns}.png"),
                   _distorted_capture(img_r, cam_dr))
        ts_lines.append(ns)
        gt.append((float(ns) * 1e-9, -R.T @ t))
    with open(tmp_path / "timestamps.txt", "w") as f:
        f.write("\n".join(ts_lines) + "\n")
    with open(tmp_path / "settings.yaml", "w") as f:
        f.write(yaml_text)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = _run_driver([os.path.join(repo, "examples", "run_euroc.py"),
                     "stereo", str(tmp_path / "settings.yaml"), str(seq),
                     str(tmp_path / "timestamps.txt")],
                    cwd=str(tmp_path))
    assert "rectifying with LEFT./RIGHT." in r.stdout

    from orb_slam2_annotate_tpu.io import evaluation

    rows = np.loadtxt(str(tmp_path / "CameraTrajectory.txt"))
    assert rows.ndim == 2 and rows.shape[0] >= 12, "too few tracked frames"
    est, gtm = [], []
    gts = np.asarray([g[0] for g in gt])
    for row in rows:
        i = int(np.argmin(np.abs(gts - row[0])))
        if abs(gts[i] - row[0]) < 1e-3:
            est.append(row[1:4])
            gtm.append(gt[i][1])
    ate, _ = evaluation.ate_rmse(np.stack(est), np.stack(gtm),
                                 with_scale=True)
    assert ate < 0.2, f"rectified-stereo ATE {ate:.3f} m"
