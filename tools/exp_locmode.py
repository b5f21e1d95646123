"""Isolate tracking-only vs full-chain per-frame device cost: run the
bench steady-state segment once normally and once in localization mode
(the SAME compiled program with the chain branch gated off by the
loc_only operand) — the difference is the keyframe chain's amortized
share, measured inside the real fused program rather than as standalone
stage dispatches (which XLA cannot fuse/CSE the way the step program
does).

Usage: python tools/exp_locmode.py"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from bench import SensorBench, require_gpu
    import jax.numpy as jnp
    import numpy as np

    require_gpu()
    b = SensorBench("mono")
    b.prepare()
    fps_a = b.run_timed()
    print(f"full pipeline: {fps_a:.1f} fps", file=sys.stderr)

    # localization mode: chain off, same program
    b.runner.activate_localization_mode()
    start = b.n_warm + b.n_bench
    dev = [jnp.asarray(np.asarray(b.frames[k][0]))
           for k in range(start, start + b.n_bench2)]
    b.runner.block()
    t0 = time.perf_counter()
    for k, fr in enumerate(dev):
        b.runner.track_mono(fr, (start + k) / 30.0)
    b.runner.block()
    dt = time.perf_counter() - t0
    print(f"loc-mode (tracking only): {b.n_bench2 / dt:.1f} fps "
          f"({dt / b.n_bench2 * 1e3:.1f} ms/frame)", file=sys.stderr)


if __name__ == "__main__":
    main()
