"""orb_slam2_annotate_tpu — a visual SLAM engine written in JAX.

A from-scratch re-design of the capabilities of ORB-SLAM2
(Mur-Artal & Tardos TRO 2015/2017) as jitted array programs: XLA-compiled
front-end and solver code, functional (pure-pytree) map state instead of
mutex-guarded shared memory, batched RANSAC instead of sequential
hypothesis loops, and one Levenberg-Marquardt engine with
Schur-complement landmark marginalization instead of g2o.  It runs on an
NVIDIA GPU, and on the CPU for tests.

Subpackages
-----------
geometry   SE3/Sim3 Lie groups, camera models, triangulation, two-view geometry
ops        front-end kernels: pyramid, FAST, ORB descriptors, Hamming matching
solvers    LM engine: pose optimization, local/global BA, Sim3, PnP, pose graph
worldmap   functional map state (keyframes, map points, covisibility, BoW index)
pipeline   tracking / local mapping / loop closing / System facade
parallel   device-mesh sharding and distributed bundle adjustment
io         dataset readers, YAML config, trajectory export, ATE/RPE evaluation
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Geometry and normal-equation math must be true float32.  A lower
# default lets XLA run f32 dots in TF32 on the GPU (about three decimal
# digits), which breaks Lie-group orthonormality, LM convergence and the
# exact BRIEF bit tests.  Code that can take less asks for it locally.
_jax.config.update("jax_default_matmul_precision", "highest")

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=None) -> str:
    """The directory for JAX's persistent compilation cache: the one
    `JAX_COMPILATION_CACHE_DIR` names (JAX reads that variable itself),
    else `.jax_cache/` at the root of the checkout.  The path is part of
    the cache key, so the default never moves."""
    environ = _os.environ if environ is None else environ
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> None:
    """Keep compiled programs across processes on an accelerator.

    Call before the first compilation.  With `JAX_COMPILATION_CACHE_DIR`
    set, JAX already uses that directory and nothing else is set here.
    CPU runs stay uncached: XLA:CPU executables written on one host have
    crashed on load on another (SIGILL under different CPU features)."""
    if ("JAX_COMPILATION_CACHE_DIR" in _os.environ
            or _jax.default_backend() == "cpu"):
        return
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
