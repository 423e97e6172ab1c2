"""CPU repro of a loop-closing regression at multi-closure scale.

The 5-lap circular revisit bench (pipelined dispatch-ahead) once measured
loop_on ATE 86.57 m vs loop_off 0.33 m — loop closing corrupting the
trajectory at multi-closure scale. This reproduces the same scenario
at test scale (320x128, 5 laps) on the virtual CPU mesh so the mechanism
can be bisected on a host CPU.

Usage: python scripts/repro_loop5.py [--laps 5] [--chunk 10] [--per-frame]
"""

import argparse
import os
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ssvio_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=2.0)

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402


from ssvio_tpu.config import Settings  # noqa: E402
from ssvio_tpu.dataio import synthetic  # noqa: E402
from ssvio_tpu.eval import ate  # noqa: E402
from ssvio_tpu.system import System  # noqa: E402


def small_settings():
    s = Settings()
    fx = 320.0
    s.cam_left = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=160.0,
                                     cy=64.0)
    s.cam_right = dataclasses.replace(s.cam_right, fx=fx, fy=fx, cx=160.0,
                                      cy=64.0)
    s.image_width, s.image_height = 320, 128
    s.baseline_fx = 0.5 * fx
    s.max_features = 192
    s.max_landmarks = 4096
    s.max_window = 8
    s.min_init_landmarks = 60
    s.tracking_good = 10 ** 6     # keyframe nearly every frame
    s.tracking_bad = 10
    s.loop_db_min_size = 12
    s.loop_min_age = 14
    s.loop_min_gap = 5
    s.max_keyframes_db = 128
    s.loop_desc_scales = 2
    s.vocab_k = 6
    s.vocab_levels = 2
    s.loop_correction_min = 0.3   # test-scene scaling (see Settings)
    return s


def run(sys_, L, R, CH, pipelined=True, timeline=False):
    n = len(L)
    pending = None
    tl = []
    for c in range(0, n, CH):
        h = sys_.dispatch_chunk(L[c:c + CH], R[c:c + CH],
                                [0.1 * (c + j) for j in range(CH)])
        if not pipelined:
            sys_.collect_chunk(h)
        else:
            if pending is not None:
                sys_.collect_chunk(pending)
            pending = h
        if timeline:
            tl.append((c, sys_.track_health, sys_._status,
                       sys_.stats["n_loops"]))
    if pending is not None:
        sys_.collect_chunk(pending)
    sys_.finish()
    if timeline:
        print("timeline (frame, health, status, n_loops):")
        print("  " + " ".join(f"{c}:{h if h is None else int(h)}/{st}/{nl}"
                              for c, h, st, nl in tl))


def evaluate(sys_, poses):
    ts, est = sys_.keyframe_trajectory()
    gids = [k["frame_id"] for k in sys_.keyframes]
    gt = poses[gids]
    stats = ate.ape_translation(est[:, :, 3], gt[:, :, 3])
    q = max(4, len(gids) // 4)
    _, Rm, t = ate.umeyama_alignment(est[:q, :, 3], gt[:q, :, 3])
    est_al = est[:, :, 3] @ Rm.T + t
    end_drift = float(np.linalg.norm(est_al[-1] - gt[-1][:, 3]))
    return stats["rmse"], end_drift, len(gids)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--per-frame", action="store_true",
                    help="collect each chunk before dispatching the next")
    ap.add_argument("--loop-off", action="store_true")
    ap.add_argument("--no-pgo", action="store_true",
                    help="bisect: skip pose-graph optimization")
    ap.add_argument("--probe", action="store_true",
                    help="log GT errors of cur/loop KF records at each event")
    ap.add_argument("--no-screen", action="store_true",
                    help="bisect: disable per-octave FAST re-screen")
    ap.add_argument("--no-anchor-seed", action="store_true",
                    help="bisect: start the drift-rate gate un-anchored")
    ap.add_argument("--no-fuse", action="store_true",
                    help="bisect: skip mappoint fusion")
    args = ap.parse_args()

    if args.no_pgo:
        from ssvio_tpu.loopclosing import LoopClosing
        LoopClosing._pose_graph_optimize = lambda self, system: None
    if args.no_fuse:
        from ssvio_tpu import loopclosing as lcmod

        def no_fuse(m, feat, best_j, ok, loop_pos, loop_gid_arr, loop_has,
                    loop_kf_gid):
            import jax.numpy as jnp
            M = m.lm_valid.shape[0]
            return (m, jnp.arange(M, dtype=jnp.int32), m.lm_gid,
                    jnp.int32(0), jnp.int32(0))
        lcmod.LoopClosing._fuse_impl = staticmethod(no_fuse)

    s = small_settings()
    if args.no_screen:
        s.loop_screen_fast = False
    n = 120
    world = synthetic.SyntheticWorld(seed=11, wall_x=16.0, ceiling_y=-5.0)
    circ = synthetic.loop_trajectory(n, radius=6.0)
    poses = np.concatenate([circ] * args.laps + [circ[:n // 4]], axis=0)
    n_frames = (len(poses) // args.chunk) * args.chunk
    poses = poses[:n_frames]
    print(f"rendering {n_frames} frames ...", flush=True)
    L, R = synthetic.render_stereo_sequence(
        world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
        s.cam_left.cy, s.baseline, s.image_width, s.image_height)

    sys_ = System(s, enable_backend=True,
                  enable_loop_closing=not args.loop_off)
    args.timeline = True
    if args.no_anchor_seed and sys_.loopclosing is not None:
        sys_.loopclosing._residual_anchor = None
    if args.probe and sys_.loopclosing is not None:
        from ssvio_tpu.ops import se3 as se3m
        lc = sys_.loopclosing
        orig_complete = lc._complete_loop

        def rec_err(gid):
            rec = sys_._rec_by_gid.get(gid)
            if rec is None:
                return float("nan")
            fid = rec["frame_id"]
            T_wc = se3m.inverse_np(rec["T_cw"])
            return float(np.linalg.norm(T_wc[:, 3] - poses[fid][:, 3]))

        def probed(system, kf_gid, row, feat, T_cw, best_row, best_score,
                   gauge_idx=0):
            loop_gid = int(lc.db_gid[best_row])
            pre_cur, pre_loop = rec_err(kf_gid), rec_err(loop_gid)
            ev = orig_complete(system, kf_gid, row, feat, T_cw, best_row,
                               best_score, gauge_idx)
            if ev is not None and (ev.corrected or ev.error > 0):
                print(f"  PROBE kf={kf_gid} loop={loop_gid} "
                      f"pre_cur_err={pre_cur:.2f} loop_rec_err={pre_loop:.2f} "
                      f"post_cur_err={rec_err(kf_gid):.2f} "
                      f"corr={ev.error:.2f} acc={ev.corrected}", flush=True)
            return ev

        lc._complete_loop = probed
    t0 = time.time()
    run(sys_, L, R, args.chunk, pipelined=not args.per_frame,
        timeline=args.timeline)
    wall = time.time() - t0
    rmse, end_drift, nkf = evaluate(sys_, poses)
    print(f"ate_rmse={rmse:.3f} m  end_drift={end_drift:.3f} m  "
          f"n_kf={nkf}  wall={wall:.1f}s  fps={n_frames / wall:.1f}")
    import collections
    wc = collections.Counter(w.split(" at ")[0].split(" gid")[0]
                             for w in sys_.stats.get("warnings", []))
    if wc:
        print("warnings:", dict(wc))
    print(f"relocalizations={sys_.stats.get('n_relocalizations', 0)}")
    # per-frame live-estimate error profile (the trajectory list holds the
    # re-gauged readback pose of every frame): where does the estimate jump?
    fts, fposes = sys_.frame_trajectory()
    ferr = np.linalg.norm(fposes[:, :, 3] - poses[:len(fposes), :, 3], axis=1)
    prof = " ".join(f"{e:.1f}" for e in ferr[::10])
    print(f"frame_err_profile (every 10th frame): {prof}")
    if sys_.loopclosing is not None:
        evs = sys_.loopclosing.events
        acc = [e for e in evs if e.corrected]
        print(f"events={len(evs)} accepted={len(acc)} "
              f"n_fused={sys_.stats.get('n_fused', 0)}")
        for e in evs:
            print(f"  kf={e.cur_gid:4d} loop={e.loop_gid:4d} "
                  f"score={e.score:.3f} m={e.n_matches:3d} "
                  f"inl={e.n_inliers:3d} err={e.error:7.3f} "
                  f"{'ACCEPT' if e.corrected else 'reject'} "
                  f"fused={e.n_fused}")


if __name__ == "__main__":
    main()
