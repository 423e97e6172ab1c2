#!/usr/bin/env python
"""KITTI odometry batch driver — the main entry point of the engine.

Capability parity with the reference's KITTI driver
(reference test/test_system.cpp:16-53): takes a config file and a KITTI
sequence directory (the reference's gflags --config_yaml_path /
--kitti_dataset_path, test/test_system.cpp:10-14), constructs the System,
runs the synchronous per-frame loop with progress logging every 100 frames
(test_system.cpp:38-39), and dumps the trajectory in TUM format at the end
(test_system.cpp:49). Additionally evaluates ATE against KITTI ground truth
(the reference does this offline with evo) and renders a map snapshot
(the headless analog of its Pangolin window).

Usage:
    python scripts/run_kitti.py --kitti_dataset_path /data/kitti/odometry/00 \
        [--config_yaml_path config.yaml] [--gt_poses 00.txt] \
        [--save_traj traj.tum] [--snapshot map.png] [--no_loop] [--viewer]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config_yaml_path", default=None,
                   help="config file (reference YAML schema or none for "
                        "KITTI 00 defaults)")
    p.add_argument("--kitti_dataset_path", required=True,
                   help="KITTI odometry sequence dir (times.txt + image_0/1)")
    p.add_argument("--gt_poses", default=None,
                   help="KITTI ground-truth poses .txt for ATE evaluation")
    p.add_argument("--save_traj", default="./trajectory.tum",
                   help="TUM trajectory output path")
    p.add_argument("--snapshot", default=None,
                   help="render final map+trajectory to this PNG")
    p.add_argument("--no_backend", action="store_true",
                   help="disable local BA (frame-to-frame odometry only)")
    p.add_argument("--no_loop", action="store_true",
                   help="disable loop closing")
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N frames (0 = whole sequence)")
    p.add_argument("--chunk", type=int, default=0,
                   help="process N frames per device dispatch (the fast "
                        "chunked pipeline — decode, upload and compute "
                        "overlap; loop closing runs at chunk boundaries). "
                        "0 = per-frame run_step (reference-style loop, "
                        "test_system.cpp:36-48)")
    p.add_argument("--viewer", action="store_true",
                   help="live matplotlib viewer (needs a display)")
    p.add_argument("--frames_only_traj", action="store_true",
                   help="export every frame pose instead of keyframes only")
    p.add_argument("--profile_dir", default=None,
                   help="write a JAX profiler trace for frames 20..40 here")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-host JAX runtime before the run "
                        "(jax.distributed.initialize via SSVIO_COORDINATOR/"
                        "SSVIO_NUM_PROCESSES/SSVIO_PROCESS_ID env or "
                        "cluster auto-detection); the engine then runs "
                        "with the map's landmark axis sharded over the "
                        "GLOBAL device mesh, within and across hosts "
                        "(parallel/multihost.py)")
    return p.parse_args(argv)


def _run_chunked(system, loader, ts, n, chunk, viewer, gt, t0):
    """Pipelined chunk loop: decode (native loader thread) -> pad+upload
    (ChunkPrefetcher thread) -> device scan (dispatch k+1 before collecting
    k) — three-way overlap, the production analog of bench.py's timed loop.
    The reference gets its overlap from the frontend/backend thread split
    (reference backend.cpp:20-55); here chunk boundaries are the sync
    points, and loop closing runs at collect time."""
    it = iter(loader)

    def read_chunk():
        bl, br = [], []
        for _ in range(chunk):
            l, r = next(it)
            bl.append(l)
            br.append(r)
        return bl, br

    n_chunks = n // chunk
    pf = system.prefetcher()
    if n_chunks:
        pf.submit(*read_chunk())
    pending = None
    for ci in range(n_chunks):
        dev_l, dev_r = pf.get()
        c0 = ci * chunk
        h = system.dispatch_chunk(dev_l, dev_r,
                                  [float(ts[c0 + j]) for j in range(chunk)])
        if ci + 1 < n_chunks:
            pf.submit(*read_chunk())    # decode+upload ride behind compute
        if pending is not None:
            system.collect_chunk(pending)
        pending = h
        if ci % max(1, 100 // chunk) == 0:
            el = time.time() - t0
            print(f"[run_kitti] frame {c0}/{n}  "
                  f"kfs={system.stats['n_keyframes']} "
                  f"loops={system.stats['n_loops']}  "
                  f"{(c0 + chunk) / max(el, 1e-9):.1f} fps", flush=True)
        if viewer is not None:
            viewer.update(system, gt_poses_wc=gt)
    if pending is not None:
        system.collect_chunk(pending)
    pf.close()
    # tail remainder: the per-frame path (a different jitted program; only
    # ever pays off for the < chunk leftover frames)
    for i in range(n_chunks * chunk, n):
        img_l, img_r = next(it)
        system.run_step(img_l, img_r, float(ts[i]))
    system.finish()    # resolve loop candidates deferred in the last chunks


def main(argv=None, settings=None) -> int:
    """`settings`: a Settings object to run with instead of
    --config_yaml_path (callers that build one in code need no PyYAML)."""
    args = parse_args(argv)

    from ssvio_tpu.config import Settings
    from ssvio_tpu.dataio import kitti
    from ssvio_tpu.system import System
    from ssvio_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    mesh = None
    if args.distributed:
        from ssvio_tpu.parallel import multihost
        if not multihost.initialize():
            print("[run_kitti] --distributed: no coordinator configured "
                  "(set SSVIO_COORDINATOR/SSVIO_NUM_PROCESSES/"
                  "SSVIO_PROCESS_ID) and no cluster auto-detected; "
                  "continuing single-process")
        mesh = multihost.global_mesh()
        import jax
        print(f"[run_kitti] distributed: process "
              f"{jax.process_index()}/{jax.process_count()}, "
              f"{len(jax.devices())} global devices, mesh axes "
              f"{mesh.shape}")

    if settings is None:
        settings = (Settings.from_yaml(args.config_yaml_path)
                    if args.config_yaml_path else Settings())
    system = System(settings,
                    enable_backend=False if args.no_backend else None,
                    enable_loop_closing=False if args.no_loop else None,
                    mesh=mesh)

    left, right, ts = kitti.load_image_paths_and_timestamps(
        args.kitti_dataset_path)
    n = len(ts) if not args.max_frames else min(args.max_frames, len(ts))
    print(f"[run_kitti] {n} stereo frames from {args.kitti_dataset_path}")

    gt = kitti.load_kitti_gt_poses(args.gt_poses) if args.gt_poses else None

    viewer = None
    if args.viewer:
        from ssvio_tpu.viz import LiveViewer
        viewer = LiveViewer(update_every=5)

    loader = kitti.prefetching_reader(
        left[:n], right[:n],
        capacity=max(8, 2 * args.chunk) if args.chunk else 8)
    t0 = time.time()
    if args.chunk:
        _run_chunked(system, loader, ts, n, args.chunk, viewer, gt, t0)
    else:
        for i, (img_l, img_r) in enumerate(loader):
            if args.profile_dir and i == 20:
                import jax
                jax.profiler.start_trace(args.profile_dir)
            system.run_step(img_l, img_r, float(ts[i]))
            if args.profile_dir and i == 40:
                import jax
                jax.profiler.stop_trace()
            if i % 100 == 0:
                el = time.time() - t0
                print(f"[run_kitti] frame {i}/{n}  status={system.status}  "
                      f"kfs={system.stats['n_keyframes']} "
                      f"loops={system.stats['n_loops']}  "
                      f"{(i + 1) / max(el, 1e-9):.1f} fps")
            if viewer is not None:
                viewer.update(system, gt_poses_wc=gt)
    wall = time.time() - t0
    print(f"[run_kitti] done: {n} frames in {wall:.1f}s "
          f"({n / wall:.1f} fps), {system.stats['n_keyframes']} keyframes, "
          f"{system.stats['n_loops']} loop closures")
    for w in system.stats.get("warnings", []):
        print(f"[run_kitti] warning: {w}")

    system.save_trajectory_tum(args.save_traj,
                               keyframes_only=not args.frames_only_traj)
    print(f"[run_kitti] trajectory -> {args.save_traj}")

    if gt is not None:
        from ssvio_tpu.eval import ate
        ts_kf, est = system.keyframe_trajectory()
        # associate keyframes to gt rows via frame ids
        kf_frames = [k["frame_id"] for k in system.keyframes]
        gt_kf = gt[[f for f in kf_frames if f < len(gt)]]
        est = est[: len(gt_kf)]
        res = ate.ape_translation(est[:, :, 3], gt_kf[:, :, 3])
        print(f"[run_kitti] ATE (SE3 Umeyama): rmse={res['rmse']:.3f} m  "
              f"mean={res['mean']:.3f}  min={res['min']:.3f}  "
              f"max={res['max']:.3f}")

    if args.snapshot:
        from ssvio_tpu import viz
        viz.snapshot(system, args.snapshot, gt_poses_wc=gt)
        print(f"[run_kitti] map snapshot -> {args.snapshot}")
    if viewer is not None:
        viewer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
