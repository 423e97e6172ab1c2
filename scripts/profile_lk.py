"""Time the GPU LK kernel against XLA's compile of the reference, on a GPU.

    python scripts/profile_lk.py            # per level and per track
    python scripts/profile_lk.py --e2e      # also chip_smoke's straight phase
                                            # with each implementation

Per level: 512 keypoints (bench.py's settings) on each level of a rendered
KITTI-size pair, at each (keypoints per program, warps) configuration of
the kernel, against `lk._track_level`. Per track: the temporal 3-level and
stereo 4-level `lk.track`, each configuration against XLA. Times are the
median of 5 windows of 50 calls. End to end: the straight phase in the order
kernel, XLA, XLA, kernel, so drift of the card shows as a spread.
Every line carries the card's name and power limit.
"""

import argparse
import functools
import os
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 2), (4, 4), (8, 4))


def timeit(fn, *args, n=50, windows=5):
    """Median over `windows` windows of `n` back-to-back calls, seconds."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / n)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()

    import chip_smoke as cs

    label, _ = cs.phase_device()
    import jax

    import bench
    from ssvio_tpu.dataio import synthetic
    from ssvio_tpu.ops import lk, lk_triton
    from ssvio_tpu.system import System
    from ssvio_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    s = bench.make_settings()
    sys_ = System(s, enable_backend=True, enable_loop_closing=False)
    front = sys_.frontend
    L, R = cs.render(s, synthetic.straight_trajectory(2, speed=0.6),
                     synthetic.SyntheticWorld(seed=4))
    pyr0 = front.build_pyramid(sys_._pad(L[0]))
    pyr1 = front.build_pyramid(sys_._pad(L[1]))
    pyr_r = front.build_pyramid(sys_._pad(R[0]))
    feat = front.detect_features(pyr0.levels[0])
    xy, valid = feat.xy, feat.valid
    print(f"lk [{label}]: {int(valid.sum())} valid of {xy.shape[0]} slots")
    prm = front.lk_params

    for lvl in range(len(pyr0.levels)):
        a = (pyr0.levels[lvl], pyr1.levels[lvl], pyr0.gx[lvl], pyr0.gy[lvl],
             xy / 2 ** lvl, xy / 2 ** lvl, valid)
        h, w = a[0].shape
        ref = jax.jit(functools.partial(lk._track_level, params=prm))
        t_x = timeit(ref, *a)
        line = f"lk [{label}]: level {w}x{h}: xla {1e3 * t_x:.4f} ms"
        for g, nw in CONFIGS:
            with mock.patch.object(lk_triton, "GROUP", g), \
                    mock.patch.object(lk_triton, "NUM_WARPS", nw):
                ker = jax.jit(functools.partial(lk._track_level_kernel,
                                                params=prm))
                t_k = timeit(ker, *a)
            line += f" | kernel g{g}w{nw} {1e3 * t_k:.4f} ms"
        print(line, flush=True)

    for name, pa, pb, params in (("temporal", pyr0, pyr1, prm),
                                 ("stereo", pyr0, pyr_r,
                                  front.lk_params_stereo)):
        line = f"lk [{label}]: {name} {params.levels}-level track:"
        for impl, g, nw in [("xla", 0, 0)] + [("kernel", *c) for c in CONFIGS]:
            with mock.patch.object(lk_triton, "GROUP", g), \
                    mock.patch.object(lk_triton, "NUM_WARPS", nw):
                fn = jax.jit(lambda a, b, p, v, gr, params=params, impl=impl:
                             lk.track(a, b, p, p, v, params,
                                      compute_err=False, grads_prev=gr,
                                      _impl=impl))
                t = timeit(fn, pa.levels, pb.levels, xy, valid, pa.grads)
            line += f" | {impl}" + (f" g{g}w{nw}" if g else "")
            line += f" {1e3 * t:.4f} ms"
        print(line, flush=True)

    if args.e2e:
        for impl in ("kernel", "xla", "xla", "kernel"):
            with mock.patch.object(lk, "_platform_impl", lambda: impl):
                r = cs.phase_straight(s, f"{label}, LK {impl}")
            print(f"e2e [{label}]: LK {impl}: {r['fps']:.3f} frames/s, "
                  f"chunk ms p50 {1e3 * np.percentile(r['chunk_s'], 50):.3f}",
                  flush=True)


if __name__ == "__main__":
    main()
