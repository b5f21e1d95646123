"""Synthetic sequence renderer with exact ground truth.

No SLAM datasets ship with the repo (the reference's TUM/KITTI/EuRoC
fixtures are external downloads, README.md:101-173), so unit/integration
tests and benchmarks render their own scenes: a cloud of Gaussian blobs
at varied depths observed by a moving camera.  Blob centers project
exactly through the ground-truth poses, giving FAST corners and BRIEF
texture with a perfectly known trajectory; depth maps are also exact,
which exercises the RGB-D path.
"""

from __future__ import annotations

import numpy as np

from ..geometry.camera import CameraModel


class BlobScene:
    def __init__(self, n_blobs: int = 1500, seed: int = 0,
                 extent=((-4.0, 4.0), (-3.0, 3.0), (4.0, 12.0))):
        rng = np.random.RandomState(seed)
        lo = np.array([e[0] for e in extent])
        hi = np.array([e[1] for e in extent])
        self.pts = rng.uniform(lo, hi, (n_blobs, 3)).astype(np.float32)
        self.amp = rng.uniform(60, 200, n_blobs).astype(np.float32)
        self.sign = np.where(rng.rand(n_blobs) > 0.3, 1.0, -1.0).astype(np.float32)
        # mostly sharp dots (1-3 px at typical depth) + a few broad patches;
        # sharp structure is what gives FAST corners and descriptor entropy
        sharp = rng.uniform(0.06, 0.30, n_blobs)
        broad = rng.uniform(1.0, 2.5, n_blobs)
        self.size = np.where(rng.rand(n_blobs) < 0.9, sharp, broad).astype(np.float32)

    def render(self, cam: CameraModel, R: np.ndarray, t: np.ndarray,
               h: int = 480, w: int = 640, background: float = 90.0):
        """Render (image [h,w] f32, depth [h,w] f32) at pose Tcw = (R, t)."""
        fx, fy = float(cam.fx), float(cam.fy)
        cx, cy = float(cam.cx), float(cam.cy)
        xc = self.pts @ R.T + t
        z = xc[:, 2]
        vis = z > 0.5
        u = fx * xc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * xc[:, 1] / np.maximum(z, 1e-6) + cy
        sigma_px = self.size * fx / np.maximum(z, 1e-6) / 8.0

        img = np.full((h, w), background, np.float32)
        # mild gradient so the background is not flat
        img += np.linspace(0, 15, w, dtype=np.float32)[None, :]
        img += np.linspace(0, 10, h, dtype=np.float32)[:, None]
        depth = np.full((h, w), 0.0, np.float32)

        # world-fixed asymmetric lobe per blob: a secondary dot offset in a
        # blob-specific direction, so the intensity-centroid orientation is
        # well-defined and view-consistent (radially symmetric dots make
        # IC angles pure noise)
        if not hasattr(self, "_lobe"):
            rng = np.random.RandomState(12345)
            d = rng.randn(self.pts.shape[0], 3).astype(np.float32)
            self._lobe = d / np.linalg.norm(d, axis=1, keepdims=True)
        lobe_w = self.pts + self._lobe * (self.size[:, None] * 1.5)
        lc = lobe_w @ R.T + t
        lz = np.maximum(lc[:, 2], 1e-6)
        lu = fx * lc[:, 0] / lz + cx
        lv = fy * lc[:, 1] / lz + cy

        order = np.argsort(-z)  # far to near so near blobs overwrite depth
        for i in order:
            if not vis[i]:
                continue
            s = max(float(sigma_px[i]), 0.8)
            rad = int(3 * s + 1) + int(abs(lu[i] - u[i]) + abs(lv[i] - v[i]) + 2)
            ui, vi = int(round(u[i])), int(round(v[i]))
            if ui < -rad or ui >= w + rad or vi < -rad or vi >= h + rad:
                continue
            x0, x1 = max(ui - rad, 0), min(ui + rad + 1, w)
            y0, y1 = max(vi - rad, 0), min(vi + rad + 1, h)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1, dtype=np.float32) - u[i]
            ys = np.arange(y0, y1, dtype=np.float32) - v[i]
            g = np.exp(-(ys[:, None] ** 2 + xs[None, :] ** 2) / (2 * s * s))
            xs2 = np.arange(x0, x1, dtype=np.float32) - lu[i]
            ys2 = np.arange(y0, y1, dtype=np.float32) - lv[i]
            g2 = np.exp(-(ys2[:, None] ** 2 + xs2[None, :] ** 2) / (2 * s * s * 1.5))
            img[y0:y1, x0:x1] += self.sign[i] * self.amp[i] * (g + 0.55 * g2)
            m = g > 0.3
            depth[y0:y1, x0:x1][m] = z[i]
        return np.clip(img, 0, 255), depth


def orbit_trajectory(n_frames: int, radius: float = 0.0, step: float = 0.05,
                     yaw_rate: float = 0.004):
    """Sideways translation with slow yaw: list of ground-truth Tcw (R, t).

    Pose k looks down +z from position x = k*step (world), i.e. classic
    lateral sweep giving good triangulation parallax.
    """
    poses = []
    for k in range(n_frames):
        yaw = yaw_rate * k
        Rwc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ],
            np.float32,
        )
        cw = np.array([k * step, 0.015 * np.sin(k * 0.2), 0.01 * k], np.float32)
        R = Rwc.T
        t = -R @ cw
        poses.append((R, t))
    return poses


def warp_perspective(srcs, H: np.ndarray, h: int, w: int,
                     border: float = -1.0):
    """Bilinear perspective warp of same-shaped images into an [h, w]
    view: out(y, x) = src at H^-1 [x, y, 1], with `border` for samples
    outside src (cv2.warpPerspective with INTER_LINEAR and
    BORDER_CONSTANT).  The inverse map and the weights are computed once
    and shared by every image in `srcs`.  Returns a list of [h, w] f32.
    """
    Hi = np.linalg.inv(np.asarray(H, np.float64))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    zw = Hi[2, 0] * xs + Hi[2, 1] * ys + Hi[2, 2]
    ok = zw != 0  # the horizon row maps to infinity: border
    inv = 1.0 / np.where(ok, zw, 1.0)
    far = 1e6
    sx = np.where(ok, np.clip((Hi[0, 0] * xs + Hi[0, 1] * ys + Hi[0, 2])
                              * inv, -far, far), -far)
    sy = np.where(ok, np.clip((Hi[1, 0] * xs + Hi[1, 1] * ys + Hi[1, 2])
                              * inv, -far, far), -far)
    x0, y0 = np.floor(sx), np.floor(sy)
    ax = (sx - x0).astype(np.float32)
    ay = (sy - y0).astype(np.float32)
    # indices into src padded by one border pixel: every neighbour
    # outside src lands on the border ring
    th, tw = srcs[0].shape
    xa = np.clip(x0 + 1, 0, tw + 1).astype(np.intp)
    xb = np.clip(x0 + 2, 0, tw + 1).astype(np.intp)
    ya = np.clip(y0 + 1, 0, th + 1).astype(np.intp) * (tw + 2)
    yb = np.clip(y0 + 2, 0, th + 1).astype(np.intp) * (tw + 2)
    taps = ((ya + xa, (1 - ax) * (1 - ay)), (ya + xb, ax * (1 - ay)),
            (yb + xa, (1 - ax) * ay), (yb + xb, ax * ay))
    outs = []
    for src in srcs:
        p = np.pad(np.asarray(src, np.float32), 1,
                   constant_values=border).ravel()
        outs.append(sum(p[i] * wgt for i, wgt in taps))
    return outs


class PlaneScene:
    """Piecewise-planar textured scene rendered by homography warping.

    Locally planar geometry with multi-scale noise textures is a much
    closer proxy to indoor SLAM footage (TUM-style) than a blob cloud:
    descriptors see affine-ish local appearance changes, exactly as on
    real sequences.  Planes are rendered far-to-near with exact per-pixel
    depth (affine in texture coordinates), so the RGB-D path works too.
    """

    def __init__(self, seed: int = 0, tex_size: int = 768):
        rng = np.random.RandomState(seed)
        self.planes = []  # (origin, U, V, texture)

        def make_texture():
            t = np.zeros((tex_size, tex_size), np.float32)
            for octave in range(2, 7):
                n = tex_size // (2 ** octave)
                layer = rng.rand(n, n).astype(np.float32) - 0.5
                layer = np.kron(layer, np.ones((2 ** octave, 2 ** octave),
                                               np.float32))
                t += layer * (1.4 ** octave)
            t = t[:tex_size, :tex_size]
            t = 120.0 + 60.0 * t / np.abs(t).max()
            return np.clip(t, 5, 250)

        # back wall (z = 9), floor (y = 2), two side panels
        self.planes.append((np.array([-6.0, -4.0, 9.0]), np.array([12.0, 0, 0]),
                            np.array([0, 8.0, 0]), make_texture()))
        self.planes.append((np.array([-6.0, 2.0, 9.5]), np.array([12.0, 0, 0]),
                            np.array([0, 0.0, -8.0]), make_texture()))
        self.planes.append((np.array([-2.5, -1.5, 6.5]), np.array([2.0, 0, 0.3]),
                            np.array([0, 2.0, 0]), make_texture()))
        self.planes.append((np.array([1.0, -1.0, 5.5]), np.array([1.8, 0, -0.4]),
                            np.array([0, 1.8, 0]), make_texture()))

    def render(self, cam: CameraModel, R: np.ndarray, t: np.ndarray,
               h: int = 480, w: int = 640):
        K = np.array([[float(cam.fx), 0, float(cam.cx)],
                      [0, float(cam.fy), float(cam.cy)],
                      [0, 0, 1.0]], np.float64)
        img = np.full((h, w), 40.0, np.float32)
        depth = np.zeros((h, w), np.float32)

        order = []
        for pi, (O, U, V, T) in enumerate(self.planes):
            zc = (R @ (O + 0.5 * U + 0.5 * V) + t)[2]
            order.append((zc, pi))
        order.sort(reverse=True)  # far to near

        for _, pi in order:
            O, U, V, T = self.planes[pi]
            th, tw = T.shape
            # texture (s,t) in [0,1]^2 -> world -> camera -> pixels:
            # world = B @ [s, t, 1], cam = R@world + t = [R@U | R@V | R@O+t]
            B = np.stack([U, V, O], axis=1)
            M = K @ (np.hstack([R @ B[:, :2], (R @ B[:, 2] + t)[:, None]]))
            # homography texture px -> image px
            S = np.diag([1.0 / tw, 1.0 / th, 1.0])
            H = M @ S
            # z in camera frame is affine in (s,t): z = a s + b t + c
            a = (R @ U)[2]
            b = (R @ V)[2]
            c = (R @ O + t)[2]
            ramp = np.fromfunction(
                lambda yy, xx: (a * (xx + 0.5) / tw + b * (yy + 0.5) / th + c
                                ).astype(np.float32), (th, tw)
            )
            warped, wz = warp_perspective((T, ramp), H, h, w, border=-1.0)
            m = (warped >= 0) & (wz > 0.1)
            img[m] = warped[m]
            depth[m] = wz[m]
        return img, depth


def true_correspondence(cam: CameraModel, Ra, ta, Rb, tb, depth_a, xy_a):
    """Map pixels xy_a [N,2] in view A to view B via A's depth map.

    Returns (xy_b [N,2], valid [N]): exact ground-truth correspondences
    for any renderer that emits depth.  Used by descriptor-repeatability
    evaluation and pattern training.
    """
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    h, w = depth_a.shape
    xi = np.clip(np.round(xy_a[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(xy_a[:, 1]).astype(int), 0, h - 1)
    z = depth_a[yi, xi]
    ok = z > 0
    xc = np.stack([(xy_a[:, 0] - cx) / fx * z, (xy_a[:, 1] - cy) / fy * z, z], 1)
    xw = (xc - ta) @ Ra  # Ra^T (xc - ta)
    xb = xw @ Rb.T + tb
    zb = np.maximum(xb[:, 2], 1e-6)
    xy_b = np.stack([fx * xb[:, 0] / zb + cx, fy * xb[:, 1] / zb + cy], 1)
    ok &= xb[:, 2] > 0.1
    return xy_b.astype(np.float32), ok


def loop_trajectory(n_frames: int, extent: float = 1.8, step: float = 0.06):
    """Out-and-back sweep: x goes 0 -> extent -> 0, constant heading.

    The return leg revisits earlier viewpoints, which lets loop closing
    fire once drift has accumulated.
    """
    poses = []
    xs = []
    x = 0.0
    direction = 1.0
    for k in range(n_frames):
        xs.append(x)
        x += direction * step
        if x >= extent:
            direction = -1.0
        if x <= 0 and direction < 0:
            direction = 1.0
    for k, xk in enumerate(xs):
        R = np.eye(3, dtype=np.float32)
        cw = np.array([xk, 0.0, 0.0], np.float32)
        t = -R @ cw
        poses.append((R, t))
    return poses


class RoomScene(PlaneScene):
    """Four textured walls around the origin (plus floor), for true
    loop-closure scenarios: an outward-facing camera circling the room
    sees each wall in turn, so covisibility between the loop's start and
    end BREAKS mid-loop (unlike PlaneScene, where every view shares the
    back wall and tracking re-finds old points without a loop closure).
    """

    def __init__(self, seed: int = 0, half: float = 6.0, tex_size: int = 768):
        rng = np.random.RandomState(seed)
        self.planes = []

        def make_texture():
            t = np.zeros((tex_size, tex_size), np.float32)
            for octave in range(2, 7):
                n = tex_size // (2 ** octave)
                layer = rng.rand(n, n).astype(np.float32) - 0.5
                layer = np.kron(layer, np.ones((2 ** octave, 2 ** octave),
                                               np.float32))
                t += layer * (1.4 ** octave)
            t = t[:tex_size, :tex_size]
            t = 120.0 + 60.0 * t / np.abs(t).max()
            return np.clip(t, 5, 250)

        h = half
        walls = [
            (np.array([-h, -4.0, h]), np.array([2 * h, 0, 0])),    # z=+h
            (np.array([h, -4.0, h]), np.array([0, 0, -2 * h])),    # x=+h
            (np.array([h, -4.0, -h]), np.array([-2 * h, 0, 0])),   # z=-h
            (np.array([-h, -4.0, -h]), np.array([0, 0, 2 * h])),   # x=-h
        ]
        V = np.array([0, 8.0, 0])
        for O, U in walls:
            self.planes.append((O, U, V, make_texture()))
        # floor
        self.planes.append((np.array([-h, 2.0, h]), np.array([2 * h, 0, 0]),
                            np.array([0, 0, -2 * h]), make_texture()))


def make_structured_texture(rng: np.random.RandomState,
                            tex_size: int = 768) -> np.ndarray:
    """Shape-rich texture: overlapping rectangles, circles and stripe
    bands on a smooth gradient — the synthetic analog of posters,
    furniture edges and wall panels in indoor footage.  High-contrast
    REPEATED local structure (corners of axis-aligned shapes look alike)
    is exactly what starves descriptor matching relative to the noise
    textures, which are globally unique by construction."""
    t = np.zeros((tex_size, tex_size), np.float32)
    yy, xx = np.mgrid[0:tex_size, 0:tex_size].astype(np.float32)
    # smooth background gradient
    t += 40.0 + 30.0 * (xx / tex_size) + 20.0 * (yy / tex_size)
    # rectangles
    for _ in range(60):
        x0, y0 = rng.randint(0, tex_size - 40, 2)
        w, h = rng.randint(20, 160, 2)
        shade = rng.uniform(30, 230)
        t[y0:y0 + h, x0:x0 + w] = 0.35 * t[y0:y0 + h, x0:x0 + w] + 0.65 * shade
    # circles
    for _ in range(30):
        cx, cy = rng.randint(40, tex_size - 40, 2)
        r = rng.randint(10, 60)
        shade = rng.uniform(30, 230)
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        t[mask] = 0.3 * t[mask] + 0.7 * shade
    # stripe bands
    for _ in range(6):
        y0 = rng.randint(0, tex_size - 30)
        h = rng.randint(8, 24)
        period = rng.randint(16, 48)
        shade = rng.uniform(40, 220)
        stripes = ((xx[y0:y0 + h] // period) % 2).astype(np.float32)
        t[y0:y0 + h] = np.where(stripes > 0, shade, t[y0:y0 + h])
    return np.clip(t, 5, 250)


class StructuredScene(PlaneScene):
    """PlaneScene geometry with shape-rich (non-noise) textures — the
    texture class that exposed local-map association decay in round 2
    (RESULTS.md): repeated high-contrast structure defeats descriptor
    uniqueness, so the pipeline must survive on geometric gating."""

    def __init__(self, seed: int = 0, tex_size: int = 768):
        rng = np.random.RandomState(seed)
        self.planes = []
        self.planes.append((np.array([-6.0, -4.0, 9.0]), np.array([12.0, 0, 0]),
                            np.array([0, 8.0, 0]),
                            make_structured_texture(rng, tex_size)))
        self.planes.append((np.array([-6.0, 2.0, 9.5]), np.array([12.0, 0, 0]),
                            np.array([0, 0.0, -8.0]),
                            make_structured_texture(rng, tex_size)))
        self.planes.append((np.array([-2.5, -1.5, 6.5]), np.array([2.0, 0, 0.3]),
                            np.array([0, 2.0, 0]),
                            make_structured_texture(rng, tex_size)))
        self.planes.append((np.array([1.0, -1.0, 5.5]), np.array([1.8, 0, -0.4]),
                            np.array([0, 1.8, 0]),
                            make_structured_texture(rng, tex_size)))


def multi_loop_trajectory(n_frames: int, laps: float = 3.1,
                          r0: float = 1.5, dr: float = 0.35):
    """Outward-facing spiral: `laps` revolutions with the radius growing
    `dr` per lap (world->cam poses).

    The long-sequence stress shape (KITTI-00-class, reference
    README.md:130): every revolution revisits the same walls — each a
    loop-closure opportunity — while the growing radius changes the
    viewpoint enough that drift accumulates between revisits.
    """
    poses = []
    for k in range(n_frames):
        frac = laps * k / n_frames
        a = 2.0 * np.pi * frac
        r = r0 + dr * frac
        sa, ca = np.sin(a), np.cos(a)
        p = np.array([r * sa, 0.0, r * ca], np.float32)
        R = np.array([[ca, 0, -sa],
                      [0, 1, 0],
                      [sa, 0, ca]], np.float32)
        t = -R @ p
        poses.append((R, t))
    return poses


def circle_trajectory(n_frames: int, radius: float = 1.0,
                      turns: float = 1.0):
    """Outward-facing camera moving on a circle (world->cam poses).

    The translation along the circle gives mono init its baseline; the
    yaw sweep makes each wall enter and leave the view, breaking
    covisibility until the loop completes.
    """
    poses = []
    for k in range(n_frames):
        a = 2.0 * np.pi * turns * k / n_frames
        sa, ca = np.sin(a), np.cos(a)
        p = np.array([radius * sa, 0.0, radius * ca], np.float32)
        R = np.array([[ca, 0, -sa],
                      [0, 1, 0],
                      [sa, 0, ca]], np.float32)
        t = -R @ p
        poses.append((R, t))
    return poses


def render_frames_cached(scene, cam: CameraModel, poses, h: int, w: int,
                         scene_key: str, with_depth: bool = False,
                         cache_dir: str | None = None,
                         n_workers: int | None = None,
                         verbose: bool = False):
    """Render a pose sequence, memoized on disk.

    Rendering is host-side NumPy warping (tens of ms per plane at VGA),
    and the long benchmark sequences re-render the identical
    deterministic scene every run.  Frames are cached as a single uint8
    .npy (plus float16 depth) keyed by the scene/camera/trajectory hash,
    under `cache_dir` (default: `.render_cache/` at the root of the
    checkout); a second run in the same checkout loads in seconds.

    Returns (frames [F,h,w] uint8, depth [F,h,w] float32 | None).
    """
    import hashlib
    import os
    import sys
    import time
    from concurrent.futures import ThreadPoolExecutor

    from .. import _REPO_ROOT

    cache_dir = cache_dir or os.path.join(_REPO_ROOT, ".render_cache")
    pose_bytes = np.ascontiguousarray(
        np.stack([np.hstack([R.reshape(-1), t.reshape(-1)])
                  for R, t in poses]).astype(np.float32)).tobytes()
    cam_sig = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    key = hashlib.sha1(
        f"{scene_key}|{cam_sig}|{h}x{w}|d{int(with_depth)}|".encode()
        + pose_bytes).hexdigest()[:16]
    base = os.path.join(cache_dir, key)
    try:
        img = np.load(base + "_img.npy")
        dep = np.load(base + "_dep.npy").astype(np.float32) \
            if with_depth else None
        if img.shape == (len(poses), h, w):
            return img, dep
    except (OSError, ValueError):  # absent or unreadable: render
        pass

    t0 = time.perf_counter()

    def one(args):
        R, t = args
        im, dp = scene.render(cam, R, t, h=h, w=w)
        return (np.clip(im, 0, 255).astype(np.uint8),
                dp.astype(np.float16) if with_depth else None)

    # NumPy releases the GIL inside its large array loops
    n_workers = n_workers or min(16, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        rendered = list(ex.map(one, poses))
    img = np.stack([r[0] for r in rendered])
    dep16 = np.stack([r[1] for r in rendered]) if with_depth else None
    if verbose:
        print(f"render_frames_cached: {len(poses)} frames in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(base + "_img.npy", img)
        if with_depth:
            np.save(base + "_dep.npy", dep16)
    except OSError:  # the cache is best-effort
        pass
    return img, dep16.astype(np.float32) if with_depth else None
