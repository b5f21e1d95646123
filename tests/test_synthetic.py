"""The main path needs only JAX, NumPy and SciPy: the synthetic renderer
warps with NumPy, and PyYAML is imported only to read a settings file."""

import os
import subprocess
import sys

import numpy as np
import pytest

from orb_slam2_annotate_tpu import compile_cache_dir, enable_compile_cache
from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                         width=640, height=480)


def _plane_homographies(scene, R, t):
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    for O, U, V, T in scene.planes:
        th, tw = T.shape
        B = np.stack([U, V, O], axis=1)
        M = K @ np.hstack([R @ B[:, :2], (R @ B[:, 2] + t)[:, None]])
        yield T, M @ np.diag([1.0 / tw, 1.0 / th, 1.0])


@pytest.mark.parametrize("frame", [0, 60])
def test_numpy_warp_matches_opencv(frame):
    cv2 = pytest.importorskip("cv2")
    scene = synthetic.PlaneScene(seed=1)
    R, t = synthetic.orbit_trajectory(112, step=0.05)[frame]
    for T, H in _plane_homographies(scene, R, t):
        ref = cv2.warpPerspective(
            T, H, (640, 480), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0)
        out, = synthetic.warp_perspective((T,), H, 480, 640, border=-1.0)
        assert out.shape == ref.shape and out.dtype == np.float32
        assert np.abs(out - ref).max() <= 1.0
        # the renderer's coverage mask (warped >= 0) is the same
        assert np.array_equal(out >= 0, ref >= 0)


def test_warp_horizon_row_is_border():
    """A row whose inverse map has zero depth lies at infinity: border."""
    H = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, -0.1, 1.0]])  # w=0 at y=10
    src = np.full((32, 32), 7.0, np.float32)
    out, = synthetic.warp_perspective((src,), np.linalg.inv(H), 20, 16)
    assert (out[10] == -1.0).all()
    assert out[0, 0] == 7.0


def test_warp_shares_weights_across_images():
    H = np.array([[0.9, 0.05, 3.0], [-0.02, 1.1, -2.0], [1e-4, 2e-4, 1.0]])
    a = np.random.RandomState(0).rand(40, 50).astype(np.float32) * 200
    wa, wb = synthetic.warp_perspective((a, 2.0 * a), H, 30, 36,
                                        border=0.0)
    wa1, = synthetic.warp_perspective((a,), H, 30, 36, border=0.0)
    np.testing.assert_array_equal(wa, wa1)
    assert (wa > 0).mean() > 0.5
    np.testing.assert_allclose(wb, 2.0 * wa, rtol=1e-5)


def _python(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)


def test_io_imports_without_yaml():
    r = _python("import sys; sys.modules['yaml'] = None\n"
                "import orb_slam2_annotate_tpu.io as io\n"
                "print(io.config.load_settings.__name__)")
    assert r.returncode == 0, r.stderr
    assert "load_settings" in r.stdout


def test_renderer_runs_without_opencv():
    r = _python(
        "import sys; sys.modules['cv2'] = None\n"
        "from orb_slam2_annotate_tpu.geometry import CameraModel\n"
        "from orb_slam2_annotate_tpu.io import synthetic\n"
        "cam = CameraModel.create(fx=250., fy=250., cx=160., cy=120.,"
        " width=320, height=240)\n"
        "R, t = synthetic.orbit_trajectory(2)[1]\n"
        "img, dep = synthetic.PlaneScene(seed=1).render(cam, R, t, 240, 320)\n"
        "print(img.shape, float(img.std()) > 5, float(dep.max()) > 1)")
    assert r.returncode == 0, r.stderr
    assert "(240, 320) True True" in r.stdout


def test_render_cache_roundtrip(tmp_path):
    scene = synthetic.PlaneScene(seed=1)
    cam = CameraModel.create(fx=125.0, fy=125.0, cx=80.0, cy=60.0,
                             width=160, height=120)
    poses = synthetic.orbit_trajectory(3)
    img, dep = synthetic.render_frames_cached(
        scene, cam, poses, 120, 160, "k", with_depth=True,
        cache_dir=str(tmp_path), n_workers=2)
    assert img.shape == (3, 120, 160) and img.dtype == np.uint8
    assert len(os.listdir(tmp_path)) == 2
    img2, dep2 = synthetic.render_frames_cached(
        scene, cam, poses, 120, 160, "k", with_depth=True,
        cache_dir=str(tmp_path))
    np.testing.assert_array_equal(img, img2)
    np.testing.assert_array_equal(dep, dep2)


def test_compile_cache_follows_env_var():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where/else"}
    assert compile_cache_dir(env) == "/some/where/else"


def test_compile_cache_default_is_inside_checkout():
    d = compile_cache_dir({})
    assert os.path.basename(d) == ".jax_cache"
    assert os.path.commonpath([d, ROOT]) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cpu_runs_stay_uncached(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before
