"""Settings loader compatible with the reference's YAML files.

The reference reads OpenCV FileStorage YAML (Tracking.cc:53-151,
Examples/Monocular/TUM1.yaml): Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,fps,
RGB,bf}, ThDepth, DepthMapFactor, ORBextractor.{nFeatures,scaleFactor,
nLevels,iniThFAST,minThFAST}, Viewer.*.  OpenCV YAML starts with a
"%YAML:1.0" directive that PyYAML rejects, so we strip it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..geometry.camera import CameraModel
from ..pipeline.system import SlamConfig


def load_opencv_yaml(path: str) -> dict:
    import yaml  # only settings files need PyYAML

    with open(path) as f:
        text = f.read()
    # strip cv::FileStorage-isms PyYAML rejects: the %YAML:1.0 directive,
    # !!opencv-matrix tags, and `data:[..]` written without a space
    # (all present in the reference's Examples/Stereo/EuRoC.yaml)
    text = text.replace("!!opencv-matrix", "").replace("data:[", "data: [")
    lines = [
        ln for ln in text.splitlines()
        if not ln.startswith("%YAML") and not ln.strip().startswith("---")
    ]
    return yaml.safe_load("\n".join(lines)) or {}


def opencv_matrix(node: dict):
    """A parsed `!!opencv-matrix` node {rows, cols, dt, data} -> ndarray."""
    import numpy as np

    return np.asarray(node["data"], np.float64).reshape(
        int(node["rows"]), int(node["cols"])
    )


def load_stereo_rectification(path: str):
    """Build a StereoRectifier from a settings file carrying LEFT./RIGHT.
    K/D/R/P blocks (the reference applies these with
    cv::initUndistortRectifyMap in Examples/Stereo/stereo_euroc.cc:62-90).
    Returns None when the file has no rectification section."""
    d = load_opencv_yaml(path)
    if "LEFT.K" not in d:
        return None
    from ..geometry.rectify import StereoRectifier

    h = int(d.get("LEFT.height", d.get("Camera.height", 480)))
    w = int(d.get("LEFT.width", d.get("Camera.width", 752)))
    return StereoRectifier(
        opencv_matrix(d["LEFT.K"]), opencv_matrix(d["LEFT.D"]),
        opencv_matrix(d["LEFT.R"]), opencv_matrix(d["LEFT.P"]),
        opencv_matrix(d["RIGHT.K"]), opencv_matrix(d["RIGHT.D"]),
        opencv_matrix(d["RIGHT.R"]), opencv_matrix(d["RIGHT.P"]),
        height=h, width=w,
    )


@dataclass
class Settings:
    cam: CameraModel
    slam: SlamConfig
    fps: float
    rgb_order: int
    depth_map_factor: float


def load_settings(path: str, sensor: str = "mono",
                  width: int = 640, height: int = 480) -> Settings:
    d = load_opencv_yaml(path)
    g = lambda k, default=0.0: float(d.get(k, default))
    width = int(g("Camera.width", width))
    height = int(g("Camera.height", height))
    cam = CameraModel.create(
        fx=g("Camera.fx"), fy=g("Camera.fy"), cx=g("Camera.cx"), cy=g("Camera.cy"),
        k1=g("Camera.k1"), k2=g("Camera.k2"), p1=g("Camera.p1"), p2=g("Camera.p2"),
        k3=g("Camera.k3"), bf=g("Camera.bf"), width=width, height=height,
    )
    n_features = int(g("ORBextractor.nFeatures", 1024))
    slam = SlamConfig(
        sensor=sensor,
        n_features=n_features,
        n_levels=int(g("ORBextractor.nLevels", 8)),
        scale=g("ORBextractor.scaleFactor", 1.2),
        th_depth=g("ThDepth", 40.0),
        # the reference's mono-init gate of 100 matches assumes the
        # 1000-feature budget (Tracking.cc:625); scale with nFeatures so
        # smaller configs can bootstrap
        init_min_matches=min(100, max(50, n_features // 8)),
    )
    return Settings(
        cam=cam, slam=slam,
        fps=g("Camera.fps", 30.0),
        rgb_order=int(g("Camera.RGB", 1)),
        depth_map_factor=g("DepthMapFactor", 1.0),
    )
