"""Attribute in-scan per-frame device time by ablation: scan 32-frame
chunks with progressively more of the tracking step enabled. In-scan
timing avoids the per-dispatch host overhead that poisons
isolated microbenchmarks (see profile_stages.py)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from ssvio_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from ssvio_tpu import frontend as fe
from ssvio_tpu.config import Settings
from ssvio_tpu.ops import ba, camera, lk, sampling, se3

K = 32


def timeit(name, fn, *args, n=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn(*args)
        jax.block_until_ready(out)
    dt = (time.time() - t0) / n
    print(f"{name:34s} {dt * 1e3:8.1f} ms/chunk  {dt / K * 1e3:6.2f} ms/frame")
    return out


def main():
    s = Settings()
    s.max_features = 512
    s.max_landmarks = 8192
    div = 2 ** (s.lk_levels + 1)
    w = -(-s.image_width // div) * div
    h = -(-s.image_height // div) * div
    front = fe.Frontend(s, w, h, s.image_width, s.image_height)
    print("device:", jax.devices()[0].device_kind, f" image {w}x{h}",
          f" N={s.max_features}")

    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(0, 255, (K, h, w)).astype(np.float32))
    n = s.max_features
    xy = jnp.asarray(np.stack([rng.uniform(20, w - 20, n),
                               rng.uniform(20, h - 20, n)], -1)
                     .astype(np.float32))
    valid = jnp.ones((n,), bool)
    p_w = jnp.asarray(np.stack([rng.uniform(-5, 5, n), rng.uniform(-2, 2, n),
                                rng.uniform(5, 40, n)], -1).astype(np.float32))
    T0 = se3.identity()

    def scan_over(fn):
        def run(imgs):
            def step(c, img):
                return fn(c, img), ()
            c, _ = jax.lax.scan(step, front._build_pyramid(imgs[0]), imgs)
            return c
        return jax.jit(run)

    # 1. pyramid + sobel only
    def f_pyr(c, img):
        return front._build_pyramid(img)
    timeit("pyramid+sobel", scan_over(f_pyr), imgs)

    # 2. + forward LK
    def f_lk(c, img):
        pyr = front._build_pyramid(img)
        new_xy, ok, _ = lk.track(c.levels, pyr.levels, xy, xy, valid,
                                 front.lk_params, compute_err=False,
                                 grads_prev=c.grads)
        return pyr._replace(
            levels=(pyr.levels[0] + 1e-9 * new_xy.sum(),) + pyr.levels[1:])
    timeit("+ forward LK", scan_over(f_lk), imgs)

    # 3. + backward LK
    def f_lk2(c, img):
        pyr = front._build_pyramid(img)
        new_xy, ok, _ = lk.track(c.levels, pyr.levels, xy, xy, valid,
                                 front.lk_params, compute_err=False,
                                 grads_prev=c.grads)
        xy_b, ok_b, _ = lk.track(pyr.levels, c.levels, new_xy, new_xy,
                                 valid & ok, front.lk_params,
                                 compute_err=False, grads_prev=pyr.grads)
        return pyr._replace(
            levels=(pyr.levels[0] + 1e-9 * (new_xy.sum() + xy_b.sum()),)
            + pyr.levels[1:])
    timeit("+ backward LK", scan_over(f_lk2), imgs)

    # 4. + pose-only LM
    def f_lm(c, img):
        pyr = front._build_pyramid(img)
        new_xy, ok, _ = lk.track(c.levels, pyr.levels, xy, xy, valid,
                                 front.lk_params, compute_err=False,
                                 grads_prev=c.grads)
        xy_b, ok_b, _ = lk.track(pyr.levels, c.levels, new_xy, new_xy,
                                 valid & ok, front.lk_params,
                                 compute_err=False, grads_prev=pyr.grads)
        res = ba.pose_only_optimize(T0, p_w, new_xy, ok & ok_b,
                                    front._fx, front._fy, front._cx,
                                    front._cy)
        return pyr._replace(
            levels=(pyr.levels[0] + 1e-9 * res.T_cw.sum(),) + pyr.levels[1:])
    timeit("+ pose-only LM", scan_over(f_lm), imgs)

    # 5. full engine chunk (random images: INIT path dominates; also run the
    #    real bench carry for the tracking path)
    from ssvio_tpu import engine as eng
    from ssvio_tpu import map as mapmod
    engine = eng.Engine(front, enable_backend=True)
    m = mapmod.empty_map(s.max_window, s.max_landmarks)
    m = m._replace(lm_pos=p_w.repeat(s.max_landmarks // n, 0),
                   lm_valid=jnp.ones((s.max_landmarks,), bool),
                   lm_gid=jnp.arange(s.max_landmarks, dtype=jnp.int32))
    feat = fe.FeatState(xy=xy, lm_slot=jnp.arange(n, dtype=jnp.int32),
                        lm_gid=jnp.arange(n, dtype=jnp.int32), valid=valid)
    carry = eng.EngineCarry(pyr_last=front._build_pyramid(imgs[0]), feat=feat,
                            T_cw=se3.identity(), rel_motion=se3.identity(),
                            m=m, status=jnp.int32(fe.TRACKING_GOOD))

    def full(carry, imgs):
        c, outs, packed = engine._run_chunk(carry, imgs, imgs)
        return packed
    timeit("full chunk (track, no KF)", jax.jit(full), carry, imgs)


if __name__ == "__main__":
    main()
