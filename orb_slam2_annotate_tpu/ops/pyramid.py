"""Image pyramid + separable Gaussian blur.

Replaces reference ORBextractor::ComputePyramid (ORBextractor.cc:1203) and
the pre-descriptor GaussianBlur(7x7, sigma=2) call (ORBextractor.cc:1172).

Levels have distinct static shapes; under jit each level is its own
fused resize+blur.  Blur is a separable 1-D pair of shift-scale-add
passes (gaussian_blur).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (h, w) sizes, matching cvRound semantics."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale**l)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def build_pyramid(image: jnp.ndarray, n_levels: int = 8, scale: float = 1.2):
    """Grayscale f32 [H,W] image -> list of n_levels arrays (level 0 first)."""
    h, w = image.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [image]
    for l in range(1, n_levels):
        levels.append(
            jax.image.resize(image, shapes[l], method="linear", antialias=True)
        )
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_1d(ksize: int, sigma: float):
    # numpy (not jnp): a cached jnp array created inside a jit trace would
    # leak the tracer into later calls
    import numpy as np

    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)  # pure numpy: safe to cache across jit traces


def gaussian_blur(image: jnp.ndarray, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with reflected borders (BORDER_REFLECT_101).

    Expressed as two shift-scale-add passes with static weights rather
    than lax.conv: a 1-channel conv is a poor fit for convolution
    kernels built for many channels, while 2x7 fused elementwise adds
    are one memory-bound pass.
    """
    k = _gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2
    h, w = image.shape
    x = jnp.pad(image, ((half, half), (half, half)), mode="reflect")
    acc = sum(float(k[i]) * x[i:i + h, :] for i in range(ksize))
    out = sum(float(k[j]) * acc[:, j:j + w] for j in range(ksize))
    return out


def level_sigma2(n_levels: int = 8, scale: float = 1.2):
    """Per-octave sigma^2 = scale^(2*l), as the reference's mvLevelSigma2."""
    return jnp.asarray([scale ** (2 * l) for l in range(n_levels)], jnp.float32)


def level_scales(n_levels: int = 8, scale: float = 1.2):
    return jnp.asarray([scale**l for l in range(n_levels)], jnp.float32)


def features_per_level(n_features: int, n_levels: int = 8, scale: float = 1.2):
    """Geometric-series feature budget per level (ORBextractor.cc:448-458)."""
    factor = 1.0 / scale
    n_first = n_features * (1.0 - factor) / (1.0 - factor**n_levels)
    counts = []
    total = 0
    for l in range(n_levels - 1):
        c = int(round(n_first * (factor**l)))
        counts.append(c)
        total += c
    counts.append(max(n_features - total, 0))
    return counts
