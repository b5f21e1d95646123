"""Long-sequence stress run (VERDICT r3 item 3): a 1200+-frame
multi-loop spiral through the four-walled RoomScene driving the
free-running path through keyframe-culling churn, repeated live loop
closures + in-program global BA, and (from a small starting tier)
capacity growth.  This is the KITTI-00-shaped stress (reference
README.md:130) the 112-frame headline bench cannot see.

Importable (`run_long()` — bench.py embeds the result in its JSON line)
or runnable standalone:

    python tools/bench_long.py                 # on the GPU
    JAX_PLATFORMS=cpu python tools/bench_long.py --frames 400 --qvga
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def run_long(n_frames: int = 1248, vga: bool = True, n_features: int = 1024,
             n_levels: int = 8, laps: float = 3.1, r0: float = 1.5,
             dr: float = 0.35, start_max_kf: int = 128,
             block_every: int = 96, seed: int = 2, tex_size: int | None = None,
             kf_culling: bool = True, verbose: bool = True,
             start_max_frames: int | None = None, min_frames_kf: int = 2):
    """Returns a dict with fps, per-block fps timeline, loop/GBA/reset
    counters, growth events and Sim3-aligned ATE."""
    import jax

    from orb_slam2_annotate_tpu.geometry import CameraModel
    from orb_slam2_annotate_tpu.io import evaluation, synthetic
    from orb_slam2_annotate_tpu.pipeline import SlamConfig
    from orb_slam2_annotate_tpu.pipeline.device_loop import FreeRunner

    if vga:
        cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                 width=640, height=480)
        h, w = 480, 640
    else:
        cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0,
                                 width=320, height=240)
        h, w = 240, 320

    if tex_size is None:
        # texture texels per wall must resolve at the render resolution:
        # the 768-texel walls were authored for QVGA; at VGA they render
        # ~2 px/texel (low-contrast upsampling) and FAST starves on the
        # weaker wall sections (measured r4: same run tracks 99.7% at
        # QVGA, ~52% at VGA with the 768 texture)
        tex_size = 1536 if vga else 768
    scene = synthetic.RoomScene(seed=seed, tex_size=tex_size)
    poses = synthetic.multi_loop_trajectory(n_frames, laps=laps, r0=r0, dr=dr)

    cfg = SlamConfig(
        n_features=n_features, n_levels=n_levels,
        max_kf=start_max_kf, max_mp=start_max_kf * 128,
        max_frames_between_kf=6, min_frames_between_kf=min_frames_kf,
        init_min_matches=60, enable_loop_closing=True, seed=0,
        enable_kf_culling=kf_culling,
    )
    # start_max_frames < n_frames exercises the trajectory-ring doubling
    # path (device_loop._maybe_grow: rings double when the frame counter
    # reaches them) — the KITTI-length ring stress, VERDICT r4 item 8
    runner = FreeRunner(cam, cfg,
                        max_frames=start_max_frames or n_frames,
                        auto_grow=True)

    if verbose:
        print(f"bench_long: rendering {n_frames} frames "
              f"({w}x{h})...", file=sys.stderr)
    t_r = time.perf_counter()
    frames, _ = synthetic.render_frames_cached(
        scene, cam, poses, h, w,
        f"RoomScene(seed={seed},tex={tex_size})", verbose=verbose)
    if verbose:
        print(f"bench_long: rendered in {time.perf_counter() - t_r:.1f}s; "
              "warming up...", file=sys.stderr)
    runner.warmup()
    tiers = runner.grow_tiers_for(n_frames)
    if verbose:
        print(f"bench_long: prewarming capacity tiers {tiers} "
              "(mid-run growth then costs only the state migration)",
              file=sys.stderr)
    runner.prewarm_tiers(tiers)

    # timed region: dispatch everything, draining the device pipeline at
    # block boundaries to timestamp per-block throughput (block is a
    # wait, not a read — the zero-read discipline holds)
    blocks = []
    t0 = time.perf_counter()
    t_blk = t0
    for k, img in enumerate(frames):
        runner.track_mono(img, k / 30.0)
        if (k + 1) % block_every == 0 or k == n_frames - 1:
            runner.block()
            now = time.perf_counter()
            nb = block_every if (k + 1) % block_every == 0 \
                else (k + 1) % block_every
            blocks.append(round(nb / (now - t_blk), 1))
            t_blk = now
            if verbose:
                print(f"bench_long: frame {k + 1}/{n_frames} "
                      f"block fps={blocks[-1]} K={runner.cfg.max_kf}",
                      file=sys.stderr)
    total = time.perf_counter() - t0
    fps = n_frames / total

    out = runner.finish(resolve_loops=False)
    tracked = [(k, T) for k, T in out["trajectory"] if T is not None]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in tracked])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k, _ in tracked])
    ate, _ = evaluation.ate_rmse(est, gt, with_scale=True)

    # keyframe-insertion timeline from the map (proof mapping never
    # silently stalled: keyframes keep appearing across the whole run)
    m = out["map"]
    kf_fids = np.sort(np.asarray(m.kf_frame_id)[np.asarray(m.kf_valid)])
    thirds = [int(x) for x in np.searchsorted(
        kf_fids, [n_frames // 3, 2 * n_frames // 3, n_frames])]
    kf_per_third = [thirds[0], thirds[1] - thirds[0], thirds[2] - thirds[1]]

    path_len = float(np.sum(np.linalg.norm(np.diff(
        np.stack([-R.T @ t for R, t in poses]), axis=0), axis=1)))

    # lost-span diagnosis: where (and for how long) tracking dropped
    modes = np.asarray(out["modes"])          # 0/1 init, 2 ok, 3 lost
    ok_mask = modes == 2
    first_ok = int(np.argmax(ok_mask)) if ok_mask.any() else -1
    spans = []
    in_bad, start = False, 0
    for k in range(first_ok, n_frames):
        bad = not ok_mask[k]
        if bad and not in_bad:
            in_bad, start = True, k
        elif not bad and in_bad:
            in_bad = False
            spans.append((start, k - 1))
    if in_bad:
        spans.append((start, n_frames - 1))
    spans.sort(key=lambda s: s[0] - s[1])
    nloc = np.asarray(out["n_local"])
    nloc_ok = nloc[ok_mask] if ok_mask.any() else np.zeros(1)
    pre_loss = [int(np.median(nloc[max(0, s - 10):s]))
                for s, _ in sorted(spans)]
    return dict(
        frames=n_frames, resolution=f"{w}x{h}",
        features=n_features, levels=n_levels,
        fps=round(fps, 1), block_fps=blocks,
        tracked=len(tracked),
        ate_cm=round(float(ate) * 100, 2),
        path_m=round(path_len, 2),
        n_keyframes=out["n_keyframes"],
        n_mappoints=out["n_mappoints"],
        n_loops=out["n_loops_closed"],
        n_gba=out["n_gba"],
        n_resets=out["n_resets"],
        n_kf_skipped_full=out["n_kf_skipped_full"],
        n_loop_edges_dropped=out["n_loop_edges_dropped"],
        closure_frames=[int(f) for f in out["closure_records"][:, 0]],
        kf_per_third=kf_per_third,
        growth_events=[list(map(int, g)) for g in runner.growth_events],
        first_ok_frame=first_ok,
        lost_spans=[list(s) for s in spans[:8]],
        nlocal_median_ok=int(np.median(nloc_ok)),
        nlocal_before_loss=pre_loss[:8],
        platform=jax.devices()[0].platform,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1248)
    ap.add_argument("--qvga", action="store_true")
    ap.add_argument("--features", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--laps", type=float, default=3.1)
    ap.add_argument("--r0", type=float, default=1.5)
    ap.add_argument("--dr", type=float, default=0.35)
    ap.add_argument("--tex", type=int, default=None)
    ap.add_argument("--no-kf-culling", action="store_true")
    ap.add_argument("--start-frames", type=int, default=None,
                    help="initial trajectory-ring capacity (< --frames "
                         "stresses auto ring-doubling)")
    ap.add_argument("--start-kf", type=int, default=128)
    ap.add_argument("--minf", type=int, default=2,
                    help="min frames between keyframes (the zero-read "
                         "growth bound divisor)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    res = run_long(n_frames=args.frames, vga=not args.qvga,
                   n_features=args.features, n_levels=args.levels,
                   laps=args.laps, r0=args.r0, dr=args.dr, tex_size=args.tex,
                   kf_culling=not args.no_kf_culling,
                   start_max_frames=args.start_frames,
                   start_max_kf=args.start_kf, min_frames_kf=args.minf)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
