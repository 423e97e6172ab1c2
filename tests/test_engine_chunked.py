"""Chunked device-resident engine (engine.py) vs per-frame run_step.

The scan program must reproduce the per-frame pipeline: same state
machine, same keyframe cadence, same trajectory (same jitted subfunctions
in the same order — only the dispatch granularity differs)."""

import dataclasses

import numpy as np
import pytest

from ssvio_tpu.config import Settings
from ssvio_tpu.dataio import synthetic
from ssvio_tpu.eval import ate
from ssvio_tpu.system import System


def _settings():
    fx = 360.0
    s = Settings()
    s.cam_left = dataclasses.replace(s.cam_left, fx=fx, fy=fx, cx=310.0,
                                     cy=94.0)
    s.cam_right = dataclasses.replace(s.cam_right, fx=fx, fy=fx, cx=310.0,
                                      cy=94.0)
    s.image_width, s.image_height = 620, 188
    s.baseline_fx = 0.54 * fx
    s.max_features = 256
    s.max_landmarks = 4096
    s.min_init_landmarks = 100
    return s


@pytest.fixture(scope="module")
def seq():
    s = _settings()
    world = synthetic.SyntheticWorld(seed=3)
    poses = synthetic.straight_trajectory(24, speed=0.8)
    L, R = synthetic.render_stereo_sequence(
        world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
        s.cam_left.cy, s.baseline, s.image_width, s.image_height)
    return s, poses, L, R


def test_chunked_matches_per_frame(seq):
    s, poses, L, R = seq
    sys_a = System(s, enable_backend=True, enable_loop_closing=False)
    for i in range(24):
        sys_a.run_step(L[i], R[i], i * 0.1)
    sys_b = System(s, enable_backend=True, enable_loop_closing=False)
    for c in range(0, 24, 8):
        out = sys_b.run_chunk(L[c:c + 8], R[c:c + 8],
                              [0.1 * (c + j) for j in range(8)])
        assert out.shape == (8, 3, 4)

    _, ta = sys_a.frame_trajectory()
    _, tb = sys_b.frame_trajectory()
    assert len(ta) == len(tb) == 24
    # same pipeline, same order -> trajectories agree to float tolerance
    np.testing.assert_allclose(tb[:, :, 3], ta[:, :, 3], atol=5e-2)
    assert sys_b.stats["n_keyframes"] == sys_a.stats["n_keyframes"]
    assert sys_b.status == sys_a.status

    gt = poses[:, :, 3]
    res = ate.ape_translation(tb[:, :, 3], gt)
    assert res["rmse"] < 0.3, res


@pytest.mark.slow
def test_chunked_handles_partial_and_sequential_chunks(seq):
    s, poses, L, R = seq
    sys_ = System(s, enable_backend=True, enable_loop_closing=False)
    sys_.run_chunk(L[:5], R[:5])               # odd-sized chunk (recompile)
    sys_.run_chunk(L[5:10], R[5:10])           # same size: cache hit
    out = sys_.run_chunk(L[10:13], R[10:13])
    assert out.shape == (3, 3, 4)
    assert len(sys_.trajectory) == 13
    assert sys_.stats["n_keyframes"] >= 1      # at least the init keyframe


@pytest.mark.slow
def test_chunked_with_loop_closing_smoke(seq):
    """Loop closing path executes at chunk boundaries without error (full
    loop-closure correctness is covered by tests/test_loopclosing.py)."""
    s, poses, L, R = seq
    sys_ = System(s, enable_backend=True, enable_loop_closing=True)
    for c in range(0, 24, 6):
        sys_.run_chunk(L[c:c + 6], R[c:c + 6])
    assert sys_.stats["n_keyframes"] >= 1


def test_prefetcher_contract(seq):
    """ChunkPrefetcher enforces its depth bound (each in-flight chunk is
    pinned in device memory), rejects empty chunks, and surfaces worker
    exceptions at close() instead of swallowing them."""
    s, poses, L, R = seq
    sys_ = System(s, enable_backend=True, enable_loop_closing=False)
    pf = sys_.prefetcher(depth=2)
    pf.submit(L[:4], R[:4])
    pf.submit(L[4:8], R[4:8])
    with pytest.raises(RuntimeError, match="depth"):
        pf.submit(L[8:12], R[8:12])
    a = pf.get()
    b = pf.get()
    assert a[0].shape == b[0].shape and a[0].ndim == 3
    with pytest.raises(ValueError, match="empty"):
        pf.submit([], [])
    pf.close()

    # a worker-side failure (image larger than the engine canvas) must
    # surface at close() even if get() is never called
    pf2 = sys_.prefetcher(depth=2)
    big = np.zeros((s.image_height * 4, s.image_width * 4), np.uint8)
    pf2.submit([big], [big])
    with pytest.raises(Exception):
        pf2.close()
