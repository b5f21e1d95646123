"""Pinhole camera model with radial-tangential distortion.

Replaces the reference's scattered camera math: cv::undistortPoints usage
(Frame.cc:443-475 UndistortKeyPoints), projection inside ORBmatcher /
Optimizer edges, frustum test (Frame.cc:297-353 isInFrustum) and stereo
pseudo-disparity (Frame.cc:689 ComputeStereoFromRGBD).

All functions are unbatched-by-convention and vmap-friendly; intrinsics
are carried in a small NamedTuple pytree so they flow through jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CameraModel(NamedTuple):
    """Pinhole intrinsics + dist coeffs (k1,k2,p1,p2,k3) + stereo baseline.

    bf = baseline * fx (the reference's "mbf", used for the virtual right
    coordinate u_r = u - bf/depth).  width/height are the image size used
    for frustum bounds after undistortion.
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    k3: jnp.ndarray
    bf: jnp.ndarray
    width: jnp.ndarray
    height: jnp.ndarray

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480) -> "CameraModel":
        # HOST scalars, not device arrays: float(cam.fx) on a device
        # scalar would be a device->host read and a sync.  numpy scalars
        # convert to traced literals/arrays at every jit boundary at
        # zero cost.
        import numpy as _np
        f = lambda v: _np.float32(v)
        return CameraModel(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1),
                           f(p2), f(k3), f(bf), f(width), f(height))

    @property
    def K(self) -> jnp.ndarray:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            -2,
        )


def distort_normalized(cam: CameraModel, xn: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy = x * y
    xd = x * radial + 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
    return jnp.stack([xd, yd], axis=-1)


def undistort_normalized(cam: CameraModel, xd: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Invert distortion by fixed-point iteration (cv::undistortPoints-style)."""
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy = x * y
        dx = 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
        xn = jnp.stack(
            [(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], axis=-1
        )
    return xn


def undistort_pixels(cam: CameraModel, uv: jnp.ndarray) -> jnp.ndarray:
    """Undistort raw pixel keypoints to ideal pinhole pixels [..., 2]."""
    xd = jnp.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], axis=-1
    )
    xn = undistort_normalized(cam, xd)
    return jnp.stack(
        [xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], axis=-1
    )


def project(cam: CameraModel, xc: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame 3D points [..., 3] -> ideal (undistorted) pixels [..., 2].

    No distortion: matching/optimization work in the undistorted pixel frame
    like the reference (keypoints are undistorted once at extraction).
    """
    z = xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * xc[..., 0] / z_safe + cam.cx
    v = cam.fy * xc[..., 1] / z_safe + cam.cy
    return jnp.stack([u, v], axis=-1)


def project_stereo(cam: CameraModel, xc: jnp.ndarray) -> jnp.ndarray:
    """-> [u, v, u_right] with u_right = u - bf/z (reference stereo residual)."""
    uv = project(cam, xc)
    z = jnp.where(jnp.abs(xc[..., 2]) < 1e-9, 1e-9, xc[..., 2])
    ur = uv[..., 0] - cam.bf / z
    return jnp.concatenate([uv, ur[..., None]], axis=-1)


def backproject(cam: CameraModel, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """Ideal pixels + depth -> camera-frame 3D (Frame.cc:713 UnprojectStereo)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def in_image(cam: CameraModel, uv: jnp.ndarray, margin: float = 0.0) -> jnp.ndarray:
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )
