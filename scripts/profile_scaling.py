"""Scaling-efficiency report for distributed local BA (BASELINE config 5).

Runs the landmark-sharded BA step on 1/2/4/8-device meshes and reports the
wall-clock per LM solve plus scaling efficiency vs the 1-device run, on 8
virtual CPU devices. The communication pattern (psum of the O(W^2) pose
system per iteration) is the one a multi-GPU mesh runs, so this validates
the sharding and the compute/communication split on the host; it measures
no GPU or interconnect, and its times are host-CPU times.

Usage: python scripts/profile_scaling.py [M_landmarks]
       python scripts/profile_scaling.py --engine [M_landmarks]

--engine profiles the FULL engine keyframe step (pyramid + LK + pose-LM +
keyframe insert + sliding-window BA) with the map's landmark axis sharded
over each mesh via Engine(mesh=...) — the engine-integrated GSPMD path,
as opposed to the standalone shard_map BA above.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from ssvio_tpu.ops import ba
from ssvio_tpu.parallel import dist_ba


def build_problem(M, W=12, seed=0):
    rng = np.random.default_rng(seed)
    fx = fy = 718.0
    cx, cy = 607.0, 185.0
    baseline = 0.537
    p_w = np.stack([rng.uniform(-20, 20, M), rng.uniform(-5, 5, M),
                    rng.uniform(5, 60, M)], -1).astype(np.float32)
    kf_T = np.zeros((W, 3, 4), np.float32)
    kf_T[:, :3, :3] = np.eye(3)
    for w in range(W):
        kf_T[w, 2, 3] = -0.8 * w
    obs_uv = np.zeros((M, W, 2, 2), np.float32)
    obs_valid = np.zeros((M, W, 2), bool)
    for w in range(W):
        for c, bx in enumerate([0.0, baseline]):
            pc = p_w @ kf_T[w, :, :3].T + kf_T[w, :, 3] - np.array([bx, 0, 0])
            uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                           fy * pc[:, 1] / pc[:, 2] + cy], -1)
            obs_uv[:, w, c] = uv + rng.normal(0, 0.3, uv.shape)
            obs_valid[:, w, c] = (pc[:, 2] > 1.0) & (np.abs(uv[:, 0] - cx) < 640) \
                & (np.abs(uv[:, 1] - cy) < 200)
    kf_fixed = np.zeros(W, bool)
    kf_fixed[0] = True
    prob = ba.LocalBAProblem(
        kf_T_cw=jnp.asarray(kf_T + rng.normal(0, 1e-3, kf_T.shape)
                            .astype(np.float32)),
        kf_valid=jnp.ones(W, bool), kf_fixed=jnp.asarray(kf_fixed),
        lm_pos=jnp.asarray(p_w + rng.normal(0, 0.05, p_w.shape)
                           .astype(np.float32)),
        lm_valid=jnp.ones(M, bool), lm_fixed=jnp.zeros(M, bool),
        obs_uv=jnp.asarray(obs_uv), obs_valid=jnp.asarray(obs_valid))
    return prob, (fx, fy, cx, cy, baseline)


def engine_mode():
    """Full engine keyframe step across mesh sizes (Engine(mesh=...))."""
    import dataclasses

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ssvio_tpu import engine as eng
    from ssvio_tpu import frontend as fe
    from ssvio_tpu import map as mapmod
    from ssvio_tpu.config import Settings
    from ssvio_tpu.ops import se3

    M = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
    s = Settings()
    fxv = 360.0
    s.cam_left = dataclasses.replace(s.cam_left, fx=fxv, fy=fxv,
                                     cx=128.0, cy=64.0)
    s.cam_right = dataclasses.replace(s.cam_right, fx=fxv, fy=fxv,
                                      cx=128.0, cy=64.0)
    s.image_width, s.image_height = 256, 128
    s.baseline_fx = 0.54 * fxv
    s.max_features = 256
    s.max_landmarks = M
    s.max_window = 12
    s.tracking_good = 10 ** 9        # force the keyframe + BA branch
    s.tracking_bad = -1
    s.detect_octaves = 2
    front = fe.Frontend(s, s.image_width, s.image_height)

    rng = np.random.default_rng(0)
    img0 = jnp.asarray(rng.uniform(0, 255, (128, 256)).astype(np.float32))
    img1 = jnp.asarray(rng.uniform(0, 255, (128, 256)).astype(np.float32))
    n = s.max_features
    feat = fe.FeatState(
        xy=jnp.asarray(np.stack([rng.uniform(20, 236, n),
                                 rng.uniform(20, 108, n)], -1)
                       .astype(np.float32)),
        lm_slot=jnp.arange(n, dtype=jnp.int32),
        lm_gid=jnp.arange(n, dtype=jnp.int32),
        valid=jnp.ones((n,), bool),
        octave=jnp.zeros((n,), jnp.int32))
    lm_pos = jnp.asarray(np.stack([rng.uniform(-5, 5, M),
                                   rng.uniform(-2, 2, M),
                                   rng.uniform(5, 40, M)], -1)
                         .astype(np.float32))

    devices = jax.devices("cpu")
    results = {}
    for nd in (1, 2, 4, 8):
        mesh = dist_ba.make_mesh(devices[:nd])
        engine = eng.Engine(front, enable_backend=True, mesh=mesh)
        lm_sh = NamedSharding(mesh, P("lm"))
        m = mapmod.empty_map(s.max_window, M)
        m = m._replace(
            lm_pos=jax.device_put(lm_pos, lm_sh),
            lm_valid=jax.device_put(jnp.ones((M,), bool), lm_sh),
            lm_gid=jax.device_put(jnp.arange(M, dtype=jnp.int32), lm_sh),
            lm_first_kf=jax.device_put(jnp.zeros((M,), jnp.int32), lm_sh),
            obs_uv=jax.device_put(m.obs_uv, lm_sh),
            obs_valid=jax.device_put(m.obs_valid, lm_sh))
        carry = eng.EngineCarry(
            pyr_last=front._build_pyramid(img0), feat=feat,
            T_cw=jnp.asarray(se3.identity()),
            rel_motion=jnp.asarray(se3.identity()), m=m,
            status=jnp.int32(fe.TRACKING_GOOD))
        c2, out = engine.run_frame(carry, img1, img1)   # compile + warmup
        jax.block_until_ready(c2.T_cw)
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            c2, out = engine.run_frame(carry, img1, img1)
        jax.block_until_ready(c2.T_cw)
        dt = (time.time() - t0) / reps
        results[nd] = dt
        eff = results[1] / (nd * dt)
        print(f"devices={nd}  {dt*1e3:8.1f} ms/engine-step (KF+BA branch)  "
              f"speedup={results[1]/dt:5.2f}x  efficiency={100*eff:5.1f}%")


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--engine":
        engine_mode()
        return
    as_json = len(sys.argv) > 1 and sys.argv[1] == "--json"
    argv = sys.argv[2:] if as_json else sys.argv[1:]
    M = int(argv[0]) if argv else 32768
    prob, (fx, fy, cx, cy, baseline) = build_problem(M)
    devices = jax.devices("cpu")
    results = {}
    report = {"M": M, "reps": "median of 5", "solve_ms": {},
              "efficiency": {},
              "note": ("8 VIRTUAL CPU devices: validates the sharded "
                       "program and the compute/comm split; efficiency is "
                       "capped by the host's physical cores, and none of "
                       "it measures a GPU or its interconnect")}
    for n in (1, 2, 4, 8):
        mesh = dist_ba.make_mesh(devices[:n])
        step = dist_ba.distributed_local_ba(mesh, fx, fy, cx, cy, baseline,
                                            max_rounds=2, iters=10)
        sp = dist_ba.shard_problem(mesh, prob)
        for _ in range(2):                   # compile + cache warmup
            res = step(sp)
            jax.block_until_ready(res.kf_T_cw)
        # median of 5 single-solve timings: a host hiccup during any one
        # rep must not poison the scaling artifact (the r4 bench recorded
        # 2 devices SLOWER than 1 from exactly such contamination)
        times = []
        for _ in range(5):
            t0 = time.time()
            res = step(sp)
            jax.block_until_ready(res.kf_T_cw)
            times.append(time.time() - t0)
        dt = float(np.median(times))
        results[n] = dt
        eff = results[1] / (n * dt) if 1 in results else float("nan")
        report["solve_ms"][str(n)] = round(dt * 1e3, 2)
        report["efficiency"][str(n)] = round(eff, 3)
        if not as_json:
            print(f"devices={n}  {dt*1e3:8.1f} ms/solve  "
                  f"speedup={results[1]/dt:5.2f}x"
                  f"  efficiency={100*eff:5.1f}%  inlier_ratio="
                  f"{float(res.inlier_ratio):.3f}")
    if as_json:
        import json
        print("SCALING " + json.dumps(report))


if __name__ == "__main__":
    main()
