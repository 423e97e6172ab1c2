"""Benchmark: stereo VO frames/s on one GPU on KITTI-resolution synthetic data.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"},
with the card's name and power limit and the JAX device in `extra`.

The reference publishes no throughput numbers; KITTI is fed at its nominal
10 fps (reference config/kitti_00.yaml:28 — see BASELINE.md). vs_baseline is
therefore fps / 10.0, the real-time factor.

The measured path is the chunked device-resident pipeline (ssvio_tpu/
engine.py): a lax.scan over the complete per-frame step — pyramid build,
seeded pyramidal LK + FB gate, 4x10 pose-only LM, tracking state machine,
keyframe insertion + stereo triangulation + sliding-window BA under
lax.cond. Keyframe/BA work therefore rides inside the measured time.

  * The headline loops consume frames already resident in device memory
    (rendered there by dataio/synthetic_jax.py): the device-side layer.
    Three loops run in one process (System.reset() between loops, no
    re-trace); the headline fps is the median loop.
  * extra.e2e_fps feeds host uint8 frames through System.prefetcher, as a
    camera-fed deployment does (chip_smoke.run_prefetched).
  * extra.loop_bench runs a circular, revisiting trajectory with and
    without loop closing (the synthetic analog of the reference's
    result/loop.png vs backend_no_loop.png, reference README.md:50-59),
    reporting both keyframe-trajectory ATEs.

A GPU is required: without one the bench exits non-zero, and a failed
phase fails the run.

Flags/env: BENCH_CHUNK, BENCH_FRAMES, BENCH_LOOPS, BENCH_FAST=1 (skip the
e2e + accuracy extras), --warm-cache-only (compile the chunk program into
the persistent cache and exit).
"""

import json
import os
import sys
import time

import numpy as np

CHUNK = int(os.environ.get("BENCH_CHUNK", "32"))
LOOPS = int(os.environ.get("BENCH_LOOPS", "3"))
FAST = os.environ.get("BENCH_FAST", "") == "1"


def make_settings():
    from ssvio_tpu.config import Settings
    s = Settings()
    s.max_features = 512
    s.max_landmarks = 8192
    s.min_init_landmarks = 150
    s.tracking_good = 120        # KF cadence scaled to the 512 budget
    # detection budgets ride the full 512 capacity (the reference's
    # 300-init/100-steady extractor split is config parity, not a bench
    # constraint; this keeps the measured workload identical to r1-r3)
    s.n_init_features = 512
    s.n_new_features = 512
    # headline runs WITH loop closing: the straight bench
    # makes ~47 keyframes, so warm up the vocabulary early enough that BoW
    # transform + whole-DB scoring run for most of the pass (the reference
    # gate is 50, kitti_00.yaml:70 — a cadence constant, not a workload
    # knob)
    s.loop_db_min_size = 24
    return s


def _run_pass(sys_, dev_L, dev_R, n_frames, t0_frame=0.0, pipelined=True):
    """One pass over HBM-resident frames. Returns (est poses [N,3,4],
    per-chunk seconds).

    pipelined=True dispatches chunk k+1 before collecting chunk k (the
    fast path). Since r4 this composes with loop closing: corrections
    detected for chunk k apply to the in-flight chunk k+1 with one-chunk
    latency and collect re-gauges its read-back poses
    (System._gauge_events) — the reference's loop thread is equally
    asynchronous (loopclosing.cpp:39-70)."""
    times = []
    est = []
    pending = None
    for c in range(0, n_frames, CHUNK):
        t0 = time.time()
        h = sys_.dispatch_chunk(dev_L[c:c + CHUNK], dev_R[c:c + CHUNK],
                                [t0_frame + 0.1 * (c + j) for j in range(CHUNK)])
        if not pipelined:
            est.append(sys_.collect_chunk(h))
        else:
            if pending is not None:
                est.append(sys_.collect_chunk(pending))
            pending = h
        times.append(time.time() - t0)
    t0 = time.time()
    if pending is not None:
        est.append(sys_.collect_chunk(pending))
    sys_.finish()    # resolve loop candidates deferred from the last chunks
    if times:
        times[-1] += time.time() - t0
    est = np.concatenate(est, axis=0) if est else np.zeros((0, 3, 4))
    return est, times


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found '{dev.platform}' devices only",
              file=sys.stderr)
        raise SystemExit(2)

    from chip_smoke import nvidia_smi, run_prefetched
    from ssvio_tpu.dataio import synthetic, synthetic_jax
    from ssvio_tpu.eval import ate
    from ssvio_tpu.system import System
    from ssvio_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    card = nvidia_smi()
    s = make_settings()
    FX, FY, CX, CY = (s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
                      s.cam_left.cy)
    W, H = s.image_width, s.image_height
    B = s.baseline

    n_frames = int(os.environ.get("BENCH_FRAMES", 10 * CHUNK))
    n_frames -= n_frames % CHUNK
    n_frames = max(n_frames, 2 * CHUNK)

    # loop closing enabled in the headline config: ingest + BoW scoring for
    # every keyframe ride inside the measured pass, overlapped with the
    # in-flight next chunk (dispatch-ahead). No closure fires on the
    # straight trajectory (nothing revisits) — closure cost + accuracy are
    # measured by the loop_bench extra below.
    sys_ = System(s, enable_backend=True, enable_loop_closing=True)

    # ---- render the bench sequence straight into device memory.
    # default corridor (walls at +-8 m): enough NEAR structure that stereo
    # init clears min_init_landmarks under the 60x-baseline depth cap.
    # yaw_rate 0: steady-state workload (a nonzero yaw angles the camera
    # into a wall and the keyframe cadence drifts with sequence length).
    poses = synthetic.straight_trajectory(n_frames, speed=0.6, yaw_rate=0.0)
    world = synthetic.SyntheticWorld(seed=4)
    t0 = time.time()
    dev_L, dev_R = synthetic_jax.render_stereo_sequence_device(
        world, poses, FX, FY, CX, CY, B, W, H,
        pad_w=sys_.w, pad_h=sys_.h, chunk=CHUNK)
    jax.block_until_ready((dev_L, dev_R))
    render_s = time.time() - t0

    # ---- warmup pass: compiles the whole scan program (init + track + KF
    # branches all execute) and lands it in the persistent cache
    t0 = time.time()
    _run_pass(sys_, dev_L, dev_R, n_frames)
    compile_s = time.time() - t0

    if "--warm-cache-only" in sys.argv:
        print(json.dumps({"metric": "warm_cache", "value": compile_s,
                          "unit": "s", "vs_baseline": 0.0,
                          "extra": {"card": card}}))
        return

    # ---- timed loops on device-resident input, median-of-LOOPS headline.
    # keep_vocab: steady-state loop closing scores every keyframe against
    # the database (the production analog of loading a pretrained ORBvoc,
    # which is what the reference does at startup, loopclosing.cpp:32-34)
    loop_fps, all_chunk_ms = [], []
    for _ in range(LOOPS):
        sys_.reset(keep_vocab=True)
        est, times = _run_pass(sys_, dev_L, dev_R, n_frames)
        loop_fps.append(n_frames / sum(times))
        all_chunk_ms += [1e3 * t for t in times]
    fps = float(np.median(loop_fps))
    stats = ate.ape_translation(est[:, :, 3], poses[:, :, 3])

    extra = {
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "chunk": CHUNK,
        "loop_closing": "enabled (no closure on straight run; see loop_bench)",
        "loops_fps": loop_fps,
        "chunk_ms_median": float(np.median(all_chunk_ms)),
        "n_keyframes": sys_.stats["n_keyframes"],
        "n_kf_scored": (sys_.loopclosing.n if sys_.loopclosing else 0),
        "ate_rmse_m": stats["rmse"],
        "compile_s": compile_s,
        "render_s": render_s,
        "peak_bytes_in_use": (dev.memory_stats() or {}).get(
            "peak_bytes_in_use"),
    }

    if not FAST:
        # ---- end to end from host frames: camera-native u8 through the
        # production prefetcher (what run_kitti --chunk uses)
        np_L = np.asarray(dev_L)
        np_R = np.asarray(dev_R)
        sys_.reset(keep_vocab=True)
        _, wall = run_prefetched(sys_, np_L, np_R, CHUNK)
        extra["e2e_fps"] = n_frames / wall

        # ---- drift benchmark: circular revisit, loop closing ON vs OFF
        # (reference result/loop.png vs backend_no_loop.png, README.md:50-59)
        extra["loop_bench"] = _loop_accuracy_bench(s, CHUNK)

    print(json.dumps({
        "metric": "frames_per_second",
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / 10.0,
        "extra": extra,
    }))


def _loop_accuracy_bench(s, chunk):
    """ATE on a circular, revisiting trajectory with and without loop
    closing (keyframe trajectories, like the reference's TUM export)."""
    import jax

    from ssvio_tpu.dataio import synthetic, synthetic_jax
    from ssvio_tpu.eval import ate
    from ssvio_tpu.system import System

    FX, FY, CX, CY = (s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
                      s.cam_left.cy)
    # 5 laps + a quarter-lap revisit at KITTI resolution with sensor
    # noise. No per-scene gating overrides: the acceptance window is
    # scene-scaled by default (Settings.loop_correction_autoscale — the
    # detector's best match is the most recent revisit, whose one-lap
    # relative drift sits far below the reference's KITTI-absolute minimum
    # of 1.0, loopclosing.cpp:224-234).
    import dataclasses
    s = dataclasses.replace(s)
    n = 288
    circ = synthetic.loop_trajectory(n, radius=10.0)
    poses = np.concatenate([circ] * 5 + [circ[:n // 4]], axis=0)
    n_frames = (len(poses) // chunk) * chunk
    poses = poses[:n_frames]
    world = synthetic.SyntheticWorld(seed=11, wall_x=24.0, ceiling_y=-8.0)

    sys_ = System(s, enable_backend=True, enable_loop_closing=True)
    dev_L, dev_R = synthetic_jax.render_stereo_sequence_device(
        world, poses, FX, FY, CX, CY, s.baseline, s.image_width,
        s.image_height, pad_w=sys_.w, pad_h=sys_.h, chunk=chunk,
        noise_std=2.0)
    jax.block_until_ready((dev_L, dev_R))

    out = {}
    # cold pass: loop-closing jit compiles + vocabulary self-training.
    # The timed loop_on pass below reuses the vocabulary (reset(keep_vocab)
    # — the production analog of loading a pretrained ORBvoc, which is what
    # the reference does) so its fps reflects steady-state loop closing.
    t0 = time.time()
    _run_pass(sys_, dev_L, dev_R, n_frames, pipelined=False)
    cold_s = time.time() - t0
    for tag, loop_on in (("loop_on", True), ("loop_off", False)):
        sys_.reset(keep_vocab=True)
        if not loop_on:
            # loop closing OFF uses its own engine trace: the loop-on
            # engine computes the descriptor ladder inside the keyframe
            # branch (r4), which loop_off must not pay
            sys_.loopclosing = None
            sys_._engine = None
            _run_pass(sys_, dev_L, dev_R, 2 * chunk)     # compile warmup
            sys_.reset(keep_vocab=True)
            sys_.loopclosing = None
        t0 = time.time()
        # both passes pipelined (dispatch-ahead) since r4 — the fps delta
        # isolates loop-closing cost, not pipelining loss (r3 advisor)
        _run_pass(sys_, dev_L, dev_R, n_frames, pipelined=True)
        wall = time.time() - t0
        ts, est = sys_.keyframe_trajectory()
        gids = [k["frame_id"] for k in sys_.keyframes]
        gt = poses[gids]
        stats = ate.ape_translation(est[:, :, 3], gt[:, :, 3])
        # drift metric: fix the gauge on the first quarter (where drift is
        # negligible), then measure the end-of-revisit error — the
        # accumulated drift loop closing is supposed to remove. A raw
        # unaligned end error would mostly measure the unobservable global
        # gauge, not drift.
        q = max(4, len(gids) // 4)
        _, Rm, t = ate.umeyama_alignment(est[:q, :, 3], gt[:q, :, 3])
        est_al = est[:, :, 3] @ Rm.T + t
        end_drift = float(np.linalg.norm(est_al[-1] - gt[-1][:, 3]))
        out[tag] = {"ate_rmse_m": stats["rmse"],
                    "end_drift_m": end_drift,
                    "n_keyframes": len(gids),
                    "fps": n_frames / wall}
        if loop_on:
            out[tag]["n_loops"] = sys_.stats["n_loops"]
            out[tag]["n_fused"] = sys_.stats.get("n_fused", 0)
            evs = sys_.loopclosing.events
            out[tag]["n_events"] = len(evs)
            if evs:
                out[tag]["score_max"] = max(e.score for e in evs)
                out[tag]["matches_max"] = max(e.n_matches for e in evs)
                out[tag]["inliers_max"] = max(e.n_inliers for e in evs)
                out[tag]["err_range"] = [min(e.error for e in evs),
                                         max(e.error for e in evs)]
    out["cold_s"] = cold_s    # compiles + vocab self-training
    return out


if __name__ == "__main__":
    main()
