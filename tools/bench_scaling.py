"""Strong-scaling benchmark of distributed bundle adjustment.

Runs the same global-BA problem on meshes of 1/2/4/8 devices and reports
throughput + parallel efficiency (BASELINE.md asks >= 70% at 2+ hosts).

On this environment only virtual CPU devices are available
(XLA_FLAGS=--xla_force_host_platform_device_count=8 on a 2-core host),
so the numbers measure the sharding overhead / collective correctness,
NOT real interconnect scaling — virtual devices share the same cores.
Run on several GPUs for meaningful efficiency.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/bench_scaling.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_problem(C=32, Pn=4096, seed=0):
    import jax.numpy as jnp

    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.solvers.ba_core import BAProblem

    rng = np.random.RandomState(seed)
    cam = CameraModel.create(fx=400.0, fy=400.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    X = rng.uniform([-4, -3, 4], [4, 3, 12], (Pn, 3)).astype(np.float32)
    Rs, ts, cam_i, pt_i, uvs = [], [], [], [], []
    for c in range(C):
        R = np.eye(3, dtype=np.float32)
        t = np.array([-0.15 * c, 0, 0], np.float32)
        Rs.append(R)
        ts.append(t)
        Xc = X @ R.T + t
        uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 320,
                       400 * Xc[:, 1] / Xc[:, 2] + 240], 1)
        cam_i += [c] * Pn
        pt_i += list(range(Pn))
        uvs.append(uv + rng.randn(Pn, 2) * 0.4)
    E = C * Pn
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    return cam, BAProblem(
        R=jnp.asarray(np.stack(Rs)), t=jnp.asarray(np.stack(ts)),
        points=jnp.asarray(X + rng.randn(Pn, 3).astype(np.float32) * 0.03),
        cam_fixed=jnp.asarray(cam_fixed), cam_valid=jnp.ones(C, bool),
        pt_valid=jnp.ones(Pn, bool),
        cam_idx=jnp.asarray(cam_i, jnp.int32),
        pt_idx=jnp.asarray(pt_i, jnp.int32),
        uv=jnp.asarray(np.concatenate(uvs), jnp.float32),
        ur=jnp.full((E,), -1.0, jnp.float32),
        inv_sigma2=jnp.ones((E,), jnp.float32),
        edge_valid=jnp.ones((E,), bool),
    )


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import orb_slam2_annotate_tpu  # noqa: F401
    from orb_slam2_annotate_tpu.parallel import dist_ba

    n_avail = len(jax.devices())
    print(f"devices: {n_avail} x {jax.devices()[0].platform}")
    cam, prob0 = make_problem()
    results = {}
    n_list = [n for n in (1, 2, 4, 8) if n <= n_avail]
    for n in n_list:
        mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))
        prob = dist_ba.shard_ba_problem(prob0, n)
        spec_pt = NamedSharding(mesh, P("mp"))
        spec_rep = NamedSharding(mesh, P())
        prob = prob._replace(
            points=jax.device_put(prob.points, spec_pt),
            pt_valid=jax.device_put(prob.pt_valid, spec_pt),
            cam_idx=jax.device_put(prob.cam_idx, spec_pt),
            pt_idx=jax.device_put(prob.pt_idx, spec_pt),
            uv=jax.device_put(prob.uv, spec_pt),
            ur=jax.device_put(prob.ur, spec_pt),
            inv_sigma2=jax.device_put(prob.inv_sigma2, spec_pt),
            edge_valid=jax.device_put(prob.edge_valid, spec_pt),
            R=jax.device_put(prob.R, spec_rep),
            t=jax.device_put(prob.t, spec_rep),
            cam_fixed=jax.device_put(prob.cam_fixed, spec_rep),
            cam_valid=jax.device_put(prob.cam_valid, spec_rep),
        )
        step = dist_ba.make_distributed_ba(mesh, iters=8)
        out = step(cam, prob)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = step(cam, prob)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        cost = float(out[3])
        results[n] = dt
        base = results[n_list[0]]
        eff = base / (dt * n) * n_list[0]
        print(f"n={n}: {dt*1e3:8.1f} ms/solve  cost={cost:10.1f} "
              f"speedup={base/dt:5.2f}x  efficiency={eff*100:5.1f}%")

    # ---- chain-level row: the fused keyframe chain on a point-sharded
    # map (the unit the LIVE pipeline shards under shard_points=True)
    from orb_slam2_annotate_tpu.parallel.mesh import shard_map_state
    from orb_slam2_annotate_tpu.pipeline import local_mapping as lm
    from orb_slam2_annotate_tpu.pipeline.frame import Frame
    from orb_slam2_annotate_tpu.worldmap import map_state as ms
    from orb_slam2_annotate_tpu.ops.orb import DESC_WORDS

    rng = np.random.RandomState(1)
    Kk, Pp, Nn = 32, 256 * n_avail, 256
    m = ms.empty_map(Kk, Pp, Nn)
    Xw = rng.uniform([-2, -2, 4], [2, 2, 8], (Nn, 3)).astype(np.float32)
    desc = rng.randint(0, 2**32, (Nn, DESC_WORDS), np.uint64).astype(np.uint32)

    def proj(Xc):
        return np.stack([400 * Xc[:, 0] / Xc[:, 2] + 320,
                         400 * Xc[:, 1] / Xc[:, 2] + 240], 1).astype(np.float32)

    for k in range(2):
        tk_ = np.array([-0.1 * k, 0, 0], np.float32)
        uv = proj(Xw + tk_)
        m = ms.insert_keyframe(
            m, jnp.asarray(k), jnp.eye(3), jnp.asarray(tk_), k, float(k),
            jnp.asarray(uv), jnp.full((Nn,), -1.0), jnp.zeros((Nn,)),
            jnp.zeros((Nn,), jnp.int32), jnp.zeros((Nn,)),
            jnp.asarray(desc), jnp.ones((Nn,), bool),
            jnp.arange(Nn, dtype=jnp.int32))
    m = m._replace(mp_pos=m.mp_pos.at[:Nn].set(jnp.asarray(Xw)),
                   mp_valid=m.mp_valid.at[:Nn].set(True),
                   mp_desc=m.mp_desc.at[:Nn].set(jnp.asarray(desc)))
    m = ms.update_mappoint_stats(m)
    uvf = proj(Xw + np.array([-0.15, 0, 0], np.float32))
    frame = Frame(xy=jnp.asarray(uvf), xy_raw=jnp.asarray(uvf),
                  ur=jnp.full((Nn,), -1.0), depth=jnp.zeros((Nn,)),
                  octave=jnp.zeros((Nn,), jnp.int32), angle=jnp.zeros((Nn,)),
                  response=jnp.zeros((Nn,)), desc=jnp.asarray(desc),
                  valid=jnp.ones((Nn,), bool))

    chain_rows = {}
    for n in (1, n_avail):
        mesh = Mesh(np.array(jax.devices()[:n]), ("mp",))
        msh = shard_map_state(m, mesh)

        def run():
            m2, _, ci = lm.keyframe_chain(
                msh, cam, frame, jnp.eye(3),
                jnp.asarray([-0.15, 0, 0], jnp.float32),
                jnp.arange(Nn, dtype=jnp.int32), 2, 2.0, 0.0,
                has_depth=False, do_cull_recent=True,
                stats_in_triangulate=False, do_fuse=False,
                do_local_ba=True, do_kf_cull=True)
            jax.block_until_ready(m2.kf_R)
        run()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        chain_rows[n] = (time.perf_counter() - t0) / 3
        print(f"keyframe_chain n={n}: {chain_rows[n]*1e3:.1f} ms")

    base = results[n_list[0]]
    artifact = {
        "what": "strong scaling of distributed global BA "
                "(per-shard normal equations, psum-reduced camera system)"
                " + the fused keyframe chain on a point-sharded MapState",
        "platform": f"{n_avail}x virtual {jax.devices()[0].platform} "
                    "devices (XLA host-platform virtualization)",
        "caveat": "virtual devices SHARE the host's 2 physical cores: "
                  "these numbers measure sharding overhead and collective "
                  "correctness, NOT real interconnect scaling; compute-bound "
                  "speedup is impossible here by construction.  Real "
                  "efficiency needs a multi-chip slice (unavailable in "
                  "this environment).",
        "ba_problem": {"cameras": 32, "points": 4096, "edges": 32 * 4096,
                       "iters": 8},
        "ba_seconds_per_solve": {str(k): v for k, v in results.items()},
        "ba_efficiency_vs_1dev": {
            str(k): round(base / (v * k), 3) for k, v in results.items()},
        "keyframe_chain_seconds": {
            str(k): round(v, 4) for k, v in chain_rows.items()},
    }
    with open("SCALING.json", "w") as f:
        json.dump(artifact, f, indent=1)
    print("wrote SCALING.json")


if __name__ == "__main__":
    main()
