"""Smoke run of the SLAM main path on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the point-sharded path only

One process drives the card.  The one-card phases run at the width of
the reference's TUM1.yaml settings (VGA 640x480, 1024 ORB features,
8 levels, scale factor 1.2), through the entry points a user calls:

  mono       FreeRunner streaming on bench.py's PlaneScene sequence
  scan       the same runner through track_mono_sequence (chunked scan)
  stereo     FreeRunner stereo on the same scene, 64 frames
  rgbd       FreeRunner RGB-D on the same scene, 64 frames
  reference  the synchronous System (README quick start) against a
             FreeRunner on the first 40 mono frames
  loop       bench.py's RoomScene spiral for 1.2 of its 3.1 laps with
             live loop closing
  stages     each hot stage jitted for the CPU backend and for the GPU
             on the same input, compared

`--four` runs FreeRunner mono with shard_points=True over a 1-D mesh of
the four cards against the same frames unsharded on one card, and
distributed BA over the mesh against the one-device solvers.

Every phase checks its result and raises on failure, so a failed phase
exits nonzero.  Frames/s lines are host-clock timings around
`block_until_ready`, for information.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Size:
    """Image width, extractor settings and frame counts of a run."""
    width: int = 640
    n_features: int = 1024
    n_levels: int = 8
    mono_warm: int = 16
    mono_stream: int = 96
    scan_frames: int = 96
    scan_chunk: int = 48
    depth_warm: int = 16
    depth_stream: int = 48
    ref_frames: int = 40
    loop_frames: int = 483   # 1.2 of LongBench's 3.1 laps in 1248 frames
    four_frames: int = 64


FULL = Size()
# CPU rehearsal of the same phases (tests/test_chip_smoke.py)
QVGA = Size(width=320, n_features=512, n_levels=4, mono_warm=8,
            mono_stream=40, scan_frames=16, scan_chunk=8, depth_warm=8,
            depth_stream=24, ref_frames=24, loop_frames=48, four_frames=40)

ATE_MAX_CM = 10.0
TRACKED_MIN = 0.7


class PhaseFailed(AssertionError):
    pass


def check(cond, what: str):
    if not cond:
        raise PhaseFailed(what)


_T0 = time.perf_counter()


def report(phase: str, **fields):
    """Print one phase's result as `phase: {json}`, with the seconds
    since the script started."""
    fields["at_s"] = round(time.perf_counter() - _T0, 1)
    print(f"{phase}: {json.dumps(fields)}", flush=True)
    return fields


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _check_sensor_row(phase: str, row: dict):
    check(row["ok"], f"{phase}: tracked {row['tracked']}/{row['n_frames']}"
          f" (need > {TRACKED_MIN:.0%}), {row['n_keyframes']} keyframes"
          " (need >= 3), or final mode not OK")
    check(row["ate_cm"] < ATE_MAX_CM,
          f"{phase}: ATE {row['ate_cm']} cm >= {ATE_MAX_CM} cm")


# ---------------------------------------------------------------- phases


def phase_mono_scan(size: Size):
    """Streaming frames, then chunked scan, on one FreeRunner."""
    from bench import SensorBench

    b, t_render = _timed(lambda: SensorBench(
        "mono", n_warm=size.mono_warm, n_bench=size.mono_stream, n_bench2=0,
        n_bench3=size.scan_frames, width=size.width,
        n_features=size.n_features, n_levels=size.n_levels,
        scan_chunk=size.scan_chunk))
    _, t_comp = _timed(b.runner.warmup)
    _, t_comp_scan = _timed(
        lambda: b.runner.warmup_sequence(chunk=size.scan_chunk))
    for k in range(size.mono_warm):
        b._track(k)
    b.runner.block()
    fps = b.run_timed()
    fps_scan = b.run_timed_scan()
    row = b.finalize()
    traj = b.runner.finish()["trajectory"]
    scan0 = size.mono_warm + size.mono_stream
    scan_tracked = sum(T is not None for _, T in traj[scan0:])
    report("mono", render_s=t_render, compile_warmup_s=t_comp,
           frames_per_s=fps, **row)
    check(len(traj) == b.n_frames, "mono: trajectory length")
    _check_sensor_row("mono", row)
    report("scan", compile_warmup_s=t_comp_scan, frames_per_s=fps_scan,
           chunk=size.scan_chunk, tracked=scan_tracked,
           n_frames=size.scan_frames)
    check(scan_tracked > TRACKED_MIN * size.scan_frames,
          f"scan: tracked {scan_tracked}/{size.scan_frames}")
    return b


def phase_depth(size: Size, sensor: str):
    from bench import SensorBench

    b, t_render = _timed(lambda: SensorBench(
        sensor, n_warm=size.depth_warm, n_bench=size.depth_stream,
        n_bench2=0, n_bench3=0, width=size.width,
        n_features=size.n_features, n_levels=size.n_levels))
    _, t_comp = _timed(b.prepare)
    fps = b.run_timed()
    row = b.finalize()
    report(sensor, render_s=t_render, compile_warmup_s=t_comp,
           frames_per_s=fps, **row)
    _check_sensor_row(sensor, row)


def _mono_ate_m(traj, poses):
    """(Sim3-aligned ATE in m, tracked frames) of a mono trajectory."""
    from orb_slam2_annotate_tpu.io import evaluation

    tracked = [(k, T) for k, T in traj if T is not None]
    check(len(tracked) >= 8, f"only {len(tracked)} tracked frames")
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in tracked])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k, _ in tracked])
    return float(evaluation.ate_rmse(est, gt, with_scale=True)[0]), \
        len(tracked)


def phase_reference(size: Size, mono):
    """The synchronous System against FreeRunner on the same frames.
    Tolerance (tests/test_free_parity.py): the free path's Sim3-aligned
    ATE is under max(1.5 x the System's, 3 cm)."""
    from orb_slam2_annotate_tpu.pipeline import System
    from orb_slam2_annotate_tpu.pipeline.device_loop import FreeRunner

    n = size.ref_frames
    frames = [f[0] for f in mono.frames[:n]]
    poses = mono.poses[:n]
    cfg = mono.runner.cfg
    # same config and rings as the mono runner: the same step program
    free = FreeRunner(mono.cam, cfg, max_frames=mono.n_frames,
                      auto_grow=False)
    for k, img in enumerate(frames):
        free.track_mono(img, k / 30.0)
    a_free, n_free = _mono_ate_m(free.finish()["trajectory"], poses)

    sync = System(mono.cam, cfg)
    _, t_comp = _timed(sync.warmup)
    for k, img in enumerate(frames):
        sync.track_mono(img, k / 30.0)
    sync.flush()
    a_sync, n_sync = _mono_ate_m(sync.frame_trajectory(), poses)
    tol = max(1.5 * a_sync, 0.03)
    report("reference", frames=n, compile_warmup_s=t_comp,
           free_tracked=n_free, free_ate_cm=a_free * 100,
           system_tracked=n_sync, system_ate_cm=a_sync * 100,
           tolerance_cm=tol * 100)
    check(a_free < tol, f"reference: FreeRunner ATE {a_free:.4f} m vs "
          f"System {a_sync:.4f} m (tolerance {tol:.4f} m)")


def phase_loop(size: Size):
    """Live loop closing on the spiral.  A crash or a non-finite pose
    fails; the closure count is reported as it is."""
    from bench import LongBench

    lb, t_render = _timed(lambda: LongBench(
        n_frames=size.loop_frames, width=size.width,
        n_features=size.n_features, n_levels=size.n_levels))
    _, t_comp = _timed(lb.prepare)
    lb.run_timed(budget_s=float("inf"))
    rec = lb.finalize()
    report("loop", render_s=t_render, compile_warmup_s=t_comp,
           tracked=rec["tracked"], frames=rec["frames"],
           n_loops_closed=rec["n_loops"], n_gba=rec["n_gba"],
           ate_cm=rec["ate_cm"], frames_per_s=rec["fps"],
           finite=rec["finite"], n_keyframes=rec["n_keyframes"])
    check(rec["frames"] == size.loop_frames, "loop: run cut short")
    check(rec["finite"] and np.isfinite(rec["ate_cm"]),
          "loop: non-finite poses")


# ------------------------------------------------- stages, CPU vs GPU


def _on(dev, tree):
    import jax

    return jax.device_put(tree, dev)


def _both(fn, args, devs):
    """Run jitted fn with every input committed to each device."""
    import jax

    jf = jax.jit(fn)
    return [jax.device_get(jf(*_on(d, args))) for d in devs]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _ba_grid_problem(n_cams: int, n_feat: int, n_pts: int, seed: int = 0):
    """A local-BA-shaped problem: n_cams keyframes (the first 4 fixed)
    each observing n_feat of n_pts points, perturbed from the truth."""
    import jax.numpy as jnp

    from orb_slam2_annotate_tpu.geometry import lie
    from orb_slam2_annotate_tpu.solvers import ba_core

    rng = np.random.RandomState(seed)
    X = rng.uniform([-3, -2, 6], [3, 2, 12], (n_pts, 3))
    Rs = np.stack([np.asarray(lie.so3_exp(jnp.asarray(
        [0.0, 0.03 * c, 0.0], jnp.float32))) for c in range(n_cams)])
    ts = np.stack([[-0.2 * c, 0.0, 0.0] for c in range(n_cams)])
    loc = np.stack([rng.choice(n_pts, n_feat, replace=False)
                    for _ in range(n_cams)])
    Xc = np.einsum("cij,cnj->cni", Rs, X[loc]) + ts[:, None, :]
    uv = 500 * Xc[..., :2] / Xc[..., 2:] + np.array([320, 240])
    uv += rng.randn(*uv.shape) * 0.5
    fixed = np.arange(n_cams) < 4
    R0, t0 = Rs.copy(), ts.copy()
    for c in np.flatnonzero(~fixed):
        dR, dt = lie.se3_exp(jnp.asarray(rng.randn(6) * 0.01, jnp.float32))
        R0[c] = np.asarray(dR) @ Rs[c]
        t0[c] = np.asarray(dR) @ ts[c] + np.asarray(dt)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return ba_core.GridBA(
        R=f32(R0), t=f32(t0),
        points=f32(X + rng.randn(n_pts, 3) * 0.05),
        cam_fixed=jnp.asarray(fixed), cam_valid=jnp.ones(n_cams, bool),
        pt_valid=jnp.ones(n_pts, bool), pt_loc=jnp.asarray(loc, jnp.int32),
        uv=f32(uv), ur=jnp.full((n_cams, n_feat), -1.0, jnp.float32),
        inv_sigma2=jnp.ones((n_cams, n_feat), jnp.float32),
        edge_valid=jnp.ones((n_cams, n_feat), bool))


def phase_stages(size: Size, image: np.ndarray):
    """Each hot stage on the CPU backend and on the accelerator, same
    input.  Integer stages must match exactly; the others within stated
    tolerances."""
    import jax
    import jax.numpy as jnp

    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.ops import hamming, orb
    from orb_slam2_annotate_tpu.ops.extractor import ExtractorConfig, extract
    from orb_slam2_annotate_tpu.solvers import ba_core, pose_opt
    from orb_slam2_annotate_tpu.worldmap import map_state as ms

    devs = [jax.devices("cpu")[0], jax.devices()[0]]

    # f32 dots must run at full precision (not TF32): the BRIEF bits and
    # the solvers depend on it
    prec = jax.config.jax_default_matmul_precision
    rng = np.random.RandomState(0)
    A = rng.randn(512, 512).astype(np.float32)
    B = rng.randn(512, 512).astype(np.float32)
    exact = A.astype(np.float64) @ B.astype(np.float64)
    dot_err = _rel(jax.device_get(jnp.dot(*_on(devs[1], (A, B)))), exact)
    report("stages.precision", default_matmul_precision=prec,
           f32_dot_rel_err=dot_err, tolerance=1e-5)
    check(prec == "highest", f"matmul precision is {prec}")
    check(dot_err < 1e-5, f"f32 dot error {dot_err:.2e}: TF32 in force?")

    # extraction, BRIEF einsum included.  Tolerance: keypoints found by
    # both backends >= 90% and identical descriptor bits >= 99% on them;
    # blur sums and FAST scores round differently, which flips
    # near-tied selections and sign tests.
    ecfg = ExtractorConfig(n_features=size.n_features,
                           n_levels=size.n_levels)
    feats = _both(lambda im, tab: extract(im, ecfg, tab),
                  (jnp.asarray(image), orb.tables()), devs)
    fc, fg = feats
    key = lambda f: {(round(float(x), 2), round(float(y), 2), int(o)): i
                     for i, ((x, y), o, v) in enumerate(
                         zip(f.xy, f.octave, f.valid)) if v}
    kc, kg = key(fc), key(fg)
    both = sorted(set(kc) & set(kg))
    share_kp = len(both) / max(len(kg), 1)
    bits_c = np.unpackbits(fc.desc[[kc[k] for k in both]].view(np.uint8))
    bits_g = np.unpackbits(fg.desc[[kg[k] for k in both]].view(np.uint8))
    share_bits = float(np.mean(bits_c == bits_g)) if both else 0.0
    report("stages.extract", keypoints_gpu=len(kg), keypoints_cpu=len(kc),
           keypoints_both=len(both), share_keypoints=share_kp,
           identical_bit_share=share_bits, tolerance_keypoints=0.9,
           tolerance_bits=0.99)
    check(len(kg) > size.n_features // 2,
          f"extract: only {len(kg)} keypoints on the GPU")
    check(share_kp >= 0.9, f"extract: keypoints in common {share_kp:.3f}")
    check(share_bits >= 0.99, f"extract: identical bits {share_bits:.4f}")

    # Hamming distances: integer, exact
    d = np.asarray(fg.desc)
    perm = np.random.RandomState(1).permutation(d.shape[0])
    hc, hg = _both(hamming.hamming_pairwise, (d, d[perm]), devs)
    report("stages.hamming", shape=list(hg.shape),
           mismatches=int(np.sum(hc != hg)))
    check(np.array_equal(hc, hg), "hamming: CPU and GPU differ")

    # int8 covisibility dot_general: integer, exact (and against NumPy)
    K, P = 128, 16384
    m = ms.empty_map(K, P, size.n_features)
    O = np.random.RandomState(2).rand(K, P) < 0.02
    covis = lambda mm, o: ms.covisibility(mm, o)
    wc, wg = _both(covis, (m, O), devs)
    Oi = O.astype(np.int64)
    w_np = Oi @ Oi.T
    np.fill_diagonal(w_np, 0)
    hlo = jax.jit(covis).lower(m, O).compile().as_text()
    # how XLA lowered the int8 dot: a GEMM library call or fusion, or a
    # plain loop
    dots = [ln.strip() for ln in hlo.splitlines()
            if "gemm" in ln.lower() or " dot(" in ln]
    report("stages.covisibility", shape=[K, P],
           mismatches=int(np.sum(wc != wg)),
           dot_lines=[d[:240] for d in dots[:4]],
           int8_gemm=any("gemm" in d.lower() and "s8[" in d for d in dots))
    check(np.array_equal(wc, wg) and np.array_equal(wg, w_np),
          "covisibility: CPU, GPU and NumPy differ")

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                             width=640, height=480)

    # one local-BA call at the keyframe chain's width.  Tolerance:
    # relative 1e-3 on poses and cost, 1e-2 on points.  Scatter-adds run
    # as atomics on the GPU and the 3x3/6x6 solves sum in another order,
    # so each LM step differs in the last bits; a point seen over a 2.2 m
    # baseline at 6-12 m depth is weakly held along its ray and moves
    # most (max 1.05e-3 on the first H100 run, with identical cost).
    g = _ba_grid_problem(n_cams=12, n_feat=size.n_features,
                         n_pts=2 * size.n_features)
    lba = lambda cm, gg: ba_core.bundle_adjust_grid(cm, gg, 4, True)
    (Rc, tc, Xc, _, cc), (Rg, tg, Xg, _, cg) = _both(lba, (cam, g), devs)
    errs = dict(R=_rel(Rg, Rc), t=_rel(tg, tc), cost=_rel(cg, cc))
    x_err = _rel(Xg, Xc)
    report("stages.local_ba", cams=12, points=2 * size.n_features,
           rel_err=dict(errs, X=x_err), tolerance=1e-3,
           tolerance_points=1e-2)
    check(max(errs.values()) < 1e-3 and x_err < 1e-2,
          f"local BA: {errs}, points {x_err}")

    # one motion-only pose optimization, 10% outliers.  Same tolerance
    # and reason; the inlier sets may differ at the chi2 gate.
    n = size.n_features
    X = rng.uniform([-3, -2, 4], [3, 2, 10], (n, 3)).astype(np.float32)
    t_true = np.array([0.2, -0.1, 0.3], np.float32)
    Xc_ = X + t_true
    uv = np.stack([500 * Xc_[:, 0] / Xc_[:, 2] + 320,
                   500 * Xc_[:, 1] / Xc_[:, 2] + 240], 1)
    uv += rng.randn(n, 2) * 0.5
    out_idx = rng.choice(n, n // 10, replace=False)
    uv[out_idx] += rng.uniform(30, 120, (n // 10, 2))
    obs = pose_opt.PoseObs(
        xw=X, uv=uv.astype(np.float32), ur=np.full(n, -1.0, np.float32),
        inv_sigma2=np.ones(n, np.float32), valid=np.ones(n, bool))
    R0 = np.eye(3, dtype=np.float32)
    t0 = t_true + np.array([0.03, -0.02, 0.05], np.float32)
    po = lambda cm, r, t, o: pose_opt.optimize_pose(cm, r, t, o)
    (Rc, tc, ic, nc), (Rg, tg, ig, ng) = _both(po, (cam, R0, t0, obs), devs)
    errs = dict(R=_rel(Rg, Rc), t=_rel(tg, tc))
    report("stages.pose_opt", n_obs=n, rel_err=errs, tolerance=1e-3,
           inliers_cpu=int(nc), inliers_gpu=int(ng))
    check(max(errs.values()) < 1e-3, f"pose opt: {errs}")


# ------------------------------------------------------------ four cards


def phase_four(size: Size):
    """Point-sharded FreeRunner over a 4-card mesh against the same
    frames unsharded on one card; distributed BA against one device.
    Loop closing is off in both runs, as in tests/test_dist_ba.py: the
    sharded chain and tracking are what differ, and a smaller program
    compiles sooner on four cards.

    Tolerances: tracked frames equal and |ATE_sharded - ATE_one| under
    max(20%, 3 mm) (tests/test_dist_ba.py); map points valid in both
    runs differ by a median under 1% of their median norm.  Shard-local
    sums run in another order, which can flip a borderline match."""
    import jax

    from bench import SensorBench

    n_dev = len(jax.devices())
    check(n_dev == 4, f"--four needs 4 devices, JAX sees {n_dev}")
    rows, maps = {}, {}
    for shard in (True, False):
        b = SensorBench("mono", n_warm=size.mono_warm,
                        n_bench=size.four_frames - size.mono_warm,
                        n_bench2=0, n_bench3=0, width=size.width,
                        n_features=size.n_features, n_levels=size.n_levels,
                        shard_points=shard, enable_loop_closing=False)
        if shard:
            check(b.runner._mesh is not None
                  and b.runner._mesh.devices.size == 4, "no 4-device mesh")
        _, t_comp = _timed(b.prepare)
        fps = b.run_timed()
        row = b.finalize()
        rows[shard] = dict(row, compile_warmup_s=t_comp, frames_per_s=fps)
        maps[shard] = b.runner.finish()["map"]
        del b
    sh, one = rows[True], rows[False]
    vs = np.asarray(maps[True].mp_valid) & np.asarray(maps[False].mp_valid)
    d = np.linalg.norm(np.asarray(maps[True].mp_pos)[vs]
                       - np.asarray(maps[False].mp_pos)[vs], axis=1)
    scale = float(np.median(np.linalg.norm(
        np.asarray(maps[False].mp_pos)[vs], axis=1))) if vs.any() else 1.0
    mp_rel = float(np.median(d)) / scale if vs.any() else float("inf")
    ate_tol = max(0.2 * one["ate_cm"], 0.3)
    report("four.free_runner", sharded=sh, one_card=one,
           mappoints_both=int(vs.sum()), mappoint_median_rel=mp_rel,
           ate_tolerance_cm=ate_tol, mappoint_tolerance=1e-2)
    check(sh["ok"] and one["ok"], "four: a run failed its tracking checks")
    check(sh["tracked"] == one["tracked"],
          f"four: tracked {sh['tracked']} vs {one['tracked']}")
    check(abs(sh["ate_cm"] - one["ate_cm"]) < ate_tol,
          f"four: ATE {sh['ate_cm']} vs {one['ate_cm']} cm")
    check(mp_rel < 1e-2, f"four: map points differ, median rel {mp_rel}")

    report("four.dist_ba", **_dist_ba_vs_one_device())


def _dist_ba_vs_one_device():
    """make_distributed_ba over the 4-card mesh against the same solver
    on a 1-device mesh (identical arithmetic but the psum order: relative
    1e-3) and against ba_core.bundle_adjust (a different LM schedule:
    both converge under 0.8 px, rotations within 1.5e-2 rad)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.parallel import dist_ba
    from orb_slam2_annotate_tpu.solvers import ba_core

    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                             width=640, height=480)
    g = _ba_grid_problem(n_cams=8, n_feat=1024, n_pts=2048, seed=3)
    C, N = g.uv.shape[:2]
    prob = ba_core.BAProblem(
        R=g.R, t=g.t, points=g.points, cam_fixed=g.cam_fixed,
        cam_valid=g.cam_valid, pt_valid=g.pt_valid,
        cam_idx=jnp.repeat(jnp.arange(C, dtype=jnp.int32), N),
        pt_idx=g.pt_loc.reshape(-1), uv=g.uv.reshape(-1, 2),
        ur=g.ur.reshape(-1), inv_sigma2=g.inv_sigma2.reshape(-1),
        edge_valid=g.edge_valid.reshape(-1))

    def run_mesh(devs):
        mesh = Mesh(np.asarray(devs), ("mp",))
        sp, perm = dist_ba.shard_ba_problem(prob, len(devs),
                                            return_perm=True)
        pt = NamedSharding(mesh, P("mp"))
        rep = NamedSharding(mesh, P())
        sp = jax.tree.map(
            lambda x: jax.device_put(
                x, pt if x.shape[:1] in ((sp.points.shape[0],),
                                         (sp.cam_idx.shape[0],)) else rep),
            sp)
        R, t, X, cost = dist_ba.make_distributed_ba(mesh, iters=12)(cam, sp)
        return np.asarray(R), np.asarray(t), np.asarray(X)[perm]

    R4, t4, X4 = run_mesh(jax.devices()[:4])
    R1, t1, X1 = run_mesh(jax.devices()[:1])
    Rd, td, Xd, _, _ = jax.device_get(ba_core.bundle_adjust(cam, prob, 12))

    def rmse(R, t, X):
        r = ba_core.edge_residual_jac(cam, prob._replace(
            R=jnp.asarray(R), t=jnp.asarray(t), points=jnp.asarray(X)))[0]
        return float(np.sqrt(np.mean(np.sum(np.asarray(r)[:, :2] ** 2, 1))))

    ang = max(float(np.arccos(np.clip((np.trace(a @ b.T) - 1) / 2, -1, 1)))
              for a, b in zip(R4, Rd))
    res = dict(rel_err_vs_1dev=dict(R=_rel(R4, R1), t=_rel(t4, t1),
                                    X=_rel(X4, X1)),
               rmse_px_4dev=rmse(R4, t4, X4), rmse_px_dense=rmse(Rd, td, Xd),
               max_rot_diff_vs_dense=ang)
    check(max(res["rel_err_vs_1dev"].values()) < 1e-3,
          f"dist BA 4 vs 1 device: {res['rel_err_vs_1dev']}")
    check(res["rmse_px_4dev"] < 0.8 and res["rmse_px_dense"] < 0.8,
          f"BA did not converge: {res}")
    check(ang < 1.5e-2, f"dist BA vs dense rotation {ang}")
    return res


# ------------------------------------------------------------------ main


def run_one_card(size: Size):
    mono = phase_mono_scan(size)
    image = np.asarray(mono.frames[size.mono_warm][0])
    phase_reference(size, mono)
    del mono
    phase_depth(size, "stereo")
    phase_depth(size, "rgbd")
    phase_loop(size)
    phase_stages(size, image)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    from bench import require_gpu

    device = require_gpu()
    import jax

    from orb_slam2_annotate_tpu import enable_compile_cache

    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four:
        phase_four(FULL)
    else:
        run_one_card(FULL)
    stats = jax.devices()[0].memory_stats() or {}
    report("done", seconds=time.perf_counter() - t0,
           peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
