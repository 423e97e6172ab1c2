#!/usr/bin/env python
"""Run the stereo-SLAM main path once on a GPU and check what comes out.

    python chip_smoke.py                   # device, parity, straight, loop
    python chip_smoke.py --only parity     # the device phase and one other
    python chip_smoke.py --four-gpus       # sharded BA and engine, 4 GPUs vs 1

The settings are bench.py's: the KITTI-00 rig (1241x376, fx 718.856,
baseline 0.537 m), 512 feature slots, 8192 landmark slots, a 16-keyframe
window, local BA and loop closing on.

Phases:
  device    needs a GPU (no CPU fallback); prints the card's name and power
            limit as nvidia-smi gives them, the JAX version and device kind.
  parity    each GPU kernel against its plain XLA reference at real widths
            (one LK level, the 3-level temporal and 4-level stereo tracks),
            then the GPU's XLA LK and one local BA against the same calls
            on the host CPU, with the measured errors beside the bounds.
  straight  the bench's 320-frame straight corridor from host uint8 frames
            through System.prefetcher, chunk k+1 dispatched before chunk k
            is collected: one warm pass, one timed pass.
  loop      the bench's revisit scene (5 1/4 laps of a 10 m circle with
            sensor noise), loop closing on and off.

Every number printed carries the card and its power limit. A failed phase
exits non-zero at once. Only when every phase passed, the last line of
standard output is {"ok": true, "device": {...}} with the device as JAX
reports it.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

CHUNK = 32
PHASES = ("parity", "straight", "loop")

# parity bounds (px for LK, metres for BA); the kernel and the reference
# freeze keypoints at the same eps, so they differ only by summation order
LEVEL_OK_AGREE = 0.99
LEVEL_TOL_PX = 1e-3
TRACK_TOL_PX = 1e-2
BA_TOL_M = 1e-3
MAX_STRAIGHT_ATE_M = 0.25


class PhaseFailed(Exception):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as it prints it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


# --------------------------------------------------------------------------
def phase_device():
    """Returns (label, device) or exits when JAX has no GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found '{dev.platform}' "
              "devices only", file=sys.stderr)
        raise SystemExit(2)
    smi = nvidia_smi()
    print(smi)
    label = smi.splitlines()[0]
    print(f"device [{label}]: jax {jax.__version__}, kind "
          f"'{dev.device_kind}', {len(jax.devices())} device(s)")
    return label, dev


# --------------------------------------------------------------------------
def render(s, poses, world, noise_std=0.0):
    """Host uint8 stereo frames at the rig's native size (what a camera
    delivers; System pads them)."""
    from ssvio_tpu.dataio import synthetic_jax

    L, R = synthetic_jax.render_stereo_sequence_device(
        world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
        s.cam_left.cy, s.baseline, s.image_width, s.image_height,
        chunk=CHUNK, noise_std=noise_std)
    return np.asarray(L), np.asarray(R)


def run_prefetched(sys_, L, R, chunk=CHUNK):
    """Feed host frames through System.prefetcher; chunk k+1 is dispatched
    before chunk k is collected. Returns (per-chunk seconds, wall s)."""
    n = (len(L) // chunk) * chunk
    starts = list(range(0, n, chunk))
    pf = sys_.prefetcher(depth=2)
    for c in starts[:2]:
        pf.submit(list(L[c:c + chunk]), list(R[c:c + chunk]))
    times, pending = [], None
    t_start = time.perf_counter()
    for k, c in enumerate(starts):
        t0 = time.perf_counter()
        imgs_l, imgs_r = pf.get()
        if k + 2 < len(starts):
            c2 = starts[k + 2]
            pf.submit(list(L[c2:c2 + chunk]), list(R[c2:c2 + chunk]))
        h = sys_.dispatch_chunk(imgs_l, imgs_r,
                                [0.1 * (c + j) for j in range(chunk)])
        if pending is not None:
            sys_.collect_chunk(pending)
        pending = h
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    sys_.collect_chunk(pending)
    sys_.finish()
    times[-1] += time.perf_counter() - t0
    pf.close()
    return np.asarray(times), time.perf_counter() - t_start


def ba_problem(s, seed=0):
    """A local-BA problem at the settings' window and landmark capacity:
    a forward-moving stereo rig over landmarks in front of it, 0.5 px
    pixel noise, perturbed free poses and landmarks, first pose fixed."""
    import jax.numpy as jnp

    from ssvio_tpu.ops import ba, se3

    rng = np.random.default_rng(seed)
    W, M = s.max_window, s.max_landmarks
    c = s.cam_left
    p_w = np.stack([rng.uniform(-12, 12, M), rng.uniform(-3, 1.5, M),
                    rng.uniform(6, 45, M)], -1)
    T = np.zeros((W, 3, 4))
    T[:, :3, :3] = np.eye(3)
    T[:, 2, 3] = -0.6 * np.arange(W)
    obs_uv = np.zeros((M, W, 2, 2), np.float32)
    obs_valid = np.zeros((M, W, 2), bool)
    for w in range(W):
        for cam, bx in enumerate((0.0, s.baseline)):
            pc = p_w @ T[w, :, :3].T + T[w, :, 3] - np.array([bx, 0.0, 0.0])
            uv = np.stack([c.fx * pc[:, 0] / pc[:, 2] + c.cx,
                           c.fy * pc[:, 1] / pc[:, 2] + c.cy], -1)
            uv += rng.normal(0, 0.5, uv.shape)
            obs_uv[:, w, cam] = uv
            obs_valid[:, w, cam] = ((pc[:, 2] > 1.0) & (uv[:, 0] > 0)
                                    & (uv[:, 0] < s.image_width)
                                    & (uv[:, 1] > 0)
                                    & (uv[:, 1] < s.image_height))
    T0 = np.array(T, np.float32)
    for w in range(1, W):
        xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.005, 3)])
        T0[w] = np.asarray(se3.compose(se3.exp(jnp.asarray(xi, jnp.float32)),
                                       jnp.asarray(T0[w])))
    kf_fixed = np.zeros(W, bool)
    kf_fixed[0] = True
    return ba.LocalBAProblem(
        kf_T_cw=jnp.asarray(T0), kf_valid=jnp.ones(W, bool),
        kf_fixed=jnp.asarray(kf_fixed),
        lm_pos=jnp.asarray((p_w + rng.normal(0, 0.1, p_w.shape))
                           .astype(np.float32)),
        lm_valid=jnp.ones(M, bool), lm_fixed=jnp.zeros(M, bool),
        obs_uv=jnp.asarray(obs_uv), obs_valid=jnp.asarray(obs_valid))


def _local_ba(s, prob):
    from ssvio_tpu.ops import ba

    c = s.cam_left
    return ba.local_ba(prob, c.fx, c.fy, c.cx, c.cy, s.baseline)


def _lk_compare(name, label, test, ref, ref_2x, bound, min_agree=None):
    """Print and bound |test - ref| on the tracks both accept.

    The bound holds on tracks the reference settles within its iteration
    budget (given twice the budget it returns the same position): there
    both paths freeze at the same eps, so they differ only by summation
    order. A track still moving at the cap oscillates, and its last bits
    decide where the cap leaves it; those are counted and their largest
    difference is printed, not bounded."""
    (t_pts, t_ok), (r_pts, r_ok) = test[:2], ref[:2]
    t_pts, r_pts = np.asarray(t_pts), np.asarray(r_pts)
    t_ok, r_ok = np.asarray(t_ok), np.asarray(r_ok)
    settled = np.all(np.asarray(ref_2x[0]) == r_pts, axis=1)
    both = t_ok & r_ok
    err = np.abs(t_pts - r_pts).max(axis=1)
    e_set = float(err[both & settled].max(initial=0.0))
    e_uns = float(err[both & ~settled].max(initial=0.0))
    agree = float(np.mean(t_ok == r_ok))
    print(f"parity [{label}]: {name}: max |dpos| {e_set:.3g} px over "
          f"{int((both & settled).sum())} settled tracks (bound {bound}); "
          f"{int((both & ~settled).sum())} unsettled tracks, max |dpos| "
          f"{e_uns:.3g} px; ok agreement {agree:.4f}"
          + (f" (bound >= {min_agree})" if min_agree else ""))
    _check(e_set <= bound, f"{name} exceeds {bound} px")
    if min_agree:
        _check(agree >= min_agree, f"{name}: ok masks disagree")


# --------------------------------------------------------------------------
def phase_parity(s, label, kernel_impl="kernel"):
    """`kernel_impl` is 'kernel' on the GPU; the CPU rehearsal passes
    'interpret'."""
    import jax

    from ssvio_tpu.dataio import synthetic
    from ssvio_tpu.ops import lk
    from ssvio_tpu.system import System

    sys_ = System(s, enable_backend=True, enable_loop_closing=False)
    front = sys_.frontend
    poses = synthetic.straight_trajectory(2, speed=0.6)
    L, R = render(s, poses, synthetic.SyntheticWorld(seed=4))
    pyr0, pyr1, pyr_r = (front.build_pyramid(sys_._pad(im))
                         for im in (L[0], L[1], R[0]))
    feat = front.detect_features(pyr0.levels[0])
    xy, valid = feat.xy, feat.valid
    n_valid = int(valid.sum())
    _check(n_valid > s.max_features // 2,
           f"only {n_valid} features detected for the parity pair")
    h, w = pyr0.levels[0].shape
    print(f"parity [{label}]: {n_valid}/{s.max_features} keypoints on a "
          f"{w}x{h} level pair")

    if kernel_impl == "kernel":
        # what tests/test_lk_kernel.py::test_gpu_path_runs_the_kernel checks
        _check(lk._platform_impl() == "kernel",
               "the GPU platform did not select the LK kernel")
    prm, prm_st = front.lk_params, front.lk_params_stereo
    twice = lambda p: p._replace(iters=2 * p.iters)
    kernel_level = functools.partial(lk._track_level_kernel,
                                     interpret=kernel_impl == "interpret")

    def track(impl, pa, pb, params):
        return jax.jit(functools.partial(
            lk.track, params=params, compute_err=False, _impl=impl))(
                pa.levels, pb.levels, xy, xy, valid, grads_prev=pa.grads)

    def level(fn, params, *args):
        return jax.jit(functools.partial(fn, params=params))(*args)

    # one level: the finest, seeded with the reference's coarse-to-fine
    # result as the tracker does
    seed = track("xla", pyr0, pyr1, prm)[0]
    args = (pyr0.levels[0], pyr1.levels[0], pyr0.gx[0], pyr0.gy[0], xy,
            seed, valid)
    _lk_compare(f"LK level {w}x{h} kernel vs XLA", label,
                level(kernel_level, prm, *args),
                level(lk._track_level, prm, *args),
                level(lk._track_level, twice(prm), *args),
                LEVEL_TOL_PX, LEVEL_OK_AGREE)
    for name, pa, pb, params in (("temporal 3-level", pyr0, pyr1, prm),
                                 ("stereo 4-level", pyr0, pyr_r, prm_st)):
        _lk_compare(f"LK {name} track kernel vs XLA", label,
                    track(kernel_impl, pa, pb, params),
                    track("xla", pa, pb, params),
                    track("xla", pa, pb, twice(params)), TRACK_TOL_PX)

    # the device's XLA code against the host CPU's, same calls
    cpu = jax.devices("cpu")[0]
    on_cpu = lambda t: jax.device_put(t, cpu)
    c0, c1, cxy, cvalid = on_cpu((pyr0, pyr1, xy, valid))
    cpu_out = jax.jit(functools.partial(
        lk.track, params=prm, compute_err=False, _impl="xla"))(
            c0.levels, c1.levels, cxy, cxy, cvalid, grads_prev=c0.grads)
    _lk_compare("LK temporal 3-level track device XLA vs CPU", label,
                track("xla", pyr0, pyr1, prm), cpu_out,
                track("xla", pyr0, pyr1, twice(prm)), TRACK_TOL_PX)

    prob = ba_problem(s)
    res_dev = _local_ba(s, prob)
    res_cpu = _local_ba(s, on_cpu(prob))
    t_err = float(np.abs(np.asarray(res_dev.kf_T_cw)[:, :, 3]
                         - np.asarray(res_cpu.kf_T_cw)[:, :, 3]).max())
    print(f"parity [{label}]: local BA ({s.max_window} KF, "
          f"{s.max_landmarks} landmarks) device vs CPU: max |dt| "
          f"{t_err:.3g} m (bound {BA_TOL_M}), inlier ratio "
          f"{float(res_dev.inlier_ratio):.4f} vs "
          f"{float(res_cpu.inlier_ratio):.4f}")
    _check(t_err <= BA_TOL_M, "local BA on the device disagrees with the CPU")


# --------------------------------------------------------------------------
def phase_straight(s, label, n_frames=10 * CHUNK, max_ate=MAX_STRAIGHT_ATE_M):
    import jax

    from ssvio_tpu.dataio import synthetic
    from ssvio_tpu.eval import ate
    from ssvio_tpu.system import System

    poses = synthetic.straight_trajectory(n_frames, speed=0.6, yaw_rate=0.0)
    L, R = render(s, poses, synthetic.SyntheticWorld(seed=4))
    sys_ = System(s, enable_backend=True, enable_loop_closing=True)
    t0 = time.perf_counter()
    run_prefetched(sys_, L, R)
    compile_s = time.perf_counter() - t0
    sys_.reset(keep_vocab=True)
    chunk_s, wall = run_prefetched(sys_, L, R)
    _, est = sys_.frame_trajectory()
    rmse = ate.ape_translation(est[:, :, 3], poses[:len(est), :, 3])["rmse"]
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not reported")
    lost = sys_.stats["n_lost_frames"]
    print(f"straight [{label}]: {len(est)} frames, warm pass (compile "
          f"included) {compile_s:.3f} s")
    print(f"straight [{label}]: {len(est) / wall:.3f} frames/s over "
          f"{wall:.3f} s wall; chunk ms p50 "
          f"{1e3 * np.percentile(chunk_s, 50):.3f} p99 "
          f"{1e3 * np.percentile(chunk_s, 99):.3f}; peak_bytes_in_use "
          f"{peak}; keyframes {sys_.stats['n_keyframes']}; ATE RMSE "
          f"{rmse:.4f} m (bound {max_ate}); LOST frames {lost}")
    _check(rmse <= max_ate, f"straight ATE {rmse:.4f} m > {max_ate} m")
    _check(lost == 0, f"{lost} frames ended LOST")
    return {"fps": len(est) / wall, "chunk_s": chunk_s, "ate": rmse}


# --------------------------------------------------------------------------
def _keyframe_ate(sys_, poses):
    from ssvio_tpu.eval import ate

    _, est = sys_.keyframe_trajectory()
    gt = poses[[k["frame_id"] for k in sys_.keyframes]]
    return ate.ape_translation(est[:, :, 3], gt[:, :, 3])["rmse"]


def phase_loop(s, label, laps=5, lap_frames=288, require_closure=True):
    from ssvio_tpu.dataio import synthetic
    from ssvio_tpu.system import System

    circ = synthetic.loop_trajectory(lap_frames, radius=10.0)
    poses = np.concatenate([circ] * laps + [circ[:lap_frames // 4]], axis=0)
    poses = poses[:(len(poses) // CHUNK) * CHUNK]
    world = synthetic.SyntheticWorld(seed=11, wall_x=24.0, ceiling_y=-8.0)
    L, R = render(s, poses, world, noise_std=2.0)

    # loop on: a cold pass trains the vocabulary, which the timed pass
    # keeps (as a deployment loads a trained vocabulary)
    on = System(s, enable_backend=True, enable_loop_closing=True)
    run_prefetched(on, L, R)
    on.reset(keep_vocab=True)
    _, wall_on = run_prefetched(on, L, R)
    ate_on, n_loops = _keyframe_ate(on, poses), on.stats["n_loops"]

    off = System(s, enable_backend=True, enable_loop_closing=False)
    run_prefetched(off, L[:2 * CHUNK], R[:2 * CHUNK])      # compile
    off.reset()
    _, wall_off = run_prefetched(off, L, R)
    ate_off = _keyframe_ate(off, poses)
    n = len(poses)
    print(f"loop [{label}]: {n} frames; loop on: ATE {ate_on:.4f} m, "
          f"{n_loops} closures, {n / wall_on:.3f} frames/s; loop off: ATE "
          f"{ate_off:.4f} m, {n / wall_off:.3f} frames/s")
    if require_closure:
        _check(n_loops >= 1, "no loop closed on the revisit scene")
        _check(ate_on < ate_off,
               f"loop closing did not lower ATE ({ate_on:.4f} >= "
               f"{ate_off:.4f} m)")
    return {"ate_on": ate_on, "ate_off": ate_off, "n_loops": n_loops}


# --------------------------------------------------------------------------
def phase_four_gpus(s, label, devices):
    """The landmark-sharded engine and BA on 4 devices against 1."""
    from ssvio_tpu.dataio import synthetic
    from ssvio_tpu.parallel import dist_ba
    from ssvio_tpu.system import System

    _check(len(devices) >= 4, f"needs 4 devices, found {len(devices)}")
    mesh = dist_ba.make_mesh(devices[:4])
    poses = synthetic.straight_trajectory(2 * CHUNK, speed=0.6)
    L, R = render(s, poses, synthetic.SyntheticWorld(seed=4))
    runs = {}
    for tag, m in (("1", None), ("4", mesh)):
        sys_ = System(s, enable_backend=True, enable_loop_closing=False,
                      mesh=m)
        for c in range(0, 2 * CHUNK, CHUNK):
            sys_.run_chunk(list(L[c:c + CHUNK]), list(R[c:c + CHUNK]),
                           [0.1 * (c + j) for j in range(CHUNK)])
        runs[tag] = ([k["frame_id"] for k in sys_.keyframes],
                     sys_.frame_trajectory()[1])
    kf1, tr1 = runs["1"]
    kf4, tr4 = runs["4"]
    t_err = float(np.abs(tr1[:, :, 3] - tr4[:, :, 3]).max())
    print(f"four [{label}]: engine on 4 devices vs 1, {2 * CHUNK} frames: "
          f"keyframes {kf4} vs {kf1}; max |dt| {t_err:.3g} m "
          f"(bound {BA_TOL_M})")
    _check(kf1 == kf4, "keyframe decisions differ between 4 devices and 1")
    _check(t_err <= BA_TOL_M, "poses differ between 4 devices and 1")

    c = s.cam_left
    prob = ba_problem(s)
    res1 = _local_ba(s, prob)
    step = dist_ba.distributed_local_ba(mesh, c.fx, c.fy, c.cx, c.cy,
                                        s.baseline)
    res4 = step(dist_ba.shard_problem(mesh, prob))
    t_err = float(np.abs(np.asarray(res1.kf_T_cw)[:, :, 3]
                         - np.asarray(res4.kf_T_cw)[:, :, 3]).max())
    print(f"four [{label}]: distributed local BA on 4 devices vs local BA "
          f"on 1: max |dt| {t_err:.3g} m (bound {BA_TOL_M})")
    _check(t_err <= BA_TOL_M, "distributed BA differs from one device")


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", choices=PHASES,
                    help="run the device phase and this phase only")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU comparison (needs 4 GPUs)")
    args = ap.parse_args(argv)

    label, dev = phase_device()

    import jax

    import bench
    from ssvio_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    s = bench.make_settings()
    try:
        if args.four_gpus:
            phase_four_gpus(s, label, jax.devices())
        else:
            for name in ([args.only] if args.only else PHASES):
                t0 = time.perf_counter()
                globals()[f"phase_{name}"](s, label)
                print(f"{name} [{label}]: phase took "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
