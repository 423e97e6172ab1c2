"""Capture a device trace of one steady-state engine chunk and print the
top self-time ops (needs tensorboard_plugin_profile)."""

import glob
import gzip
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ssvio_tpu import engine as eng
from ssvio_tpu.config import Settings
from ssvio_tpu.dataio import synthetic
from ssvio_tpu.system import System

CHUNK = 8
LOGDIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache", "jax_trace")


def main():
    s = Settings()
    s.max_features = 512
    s.max_landmarks = 8192
    s.min_init_landmarks = 150
    s.tracking_good = 120
    n_frames = 32
    world = synthetic.SyntheticWorld(seed=4)
    poses = synthetic.straight_trajectory(n_frames, speed=0.6, yaw_rate=0.002)
    L, R = synthetic.render_stereo_sequence(
        world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
        s.cam_left.cy, s.baseline, s.image_width, s.image_height)

    sys_ = System(s, enable_backend=True, enable_loop_closing=False)
    sys_.run_chunk(L[:CHUNK], R[:CHUNK])
    sys_.run_chunk(L[CHUNK:2 * CHUNK], R[CHUNK:2 * CHUNK])

    os.makedirs(LOGDIR, exist_ok=True)
    up = sys_.upload_chunk(L[2 * CHUNK:3 * CHUNK], R[2 * CHUNK:3 * CHUNK])
    jax.block_until_ready(up)
    with jax.profiler.trace(LOGDIR):
        sys_.run_chunk(up[0], up[1])

    # ---- extract top ops from the trace
    files = glob.glob(f"{LOGDIR}/**/*.xplane.pb", recursive=True)
    files.sort(key=os.path.getmtime)
    print("xplane:", files[-1])
    from tensorboard_plugin_profile.convert import raw_to_tool_data as rtd
    for tool in ("op_profile", "hlo_stats", "framework_op_stats"):
        try:
            data = rtd.xspace_to_tool_data([files[-1]], tool, {})
            out = os.path.join(LOGDIR, f"{tool}.json")
            blob = data[0] if isinstance(data, tuple) else data
            if isinstance(blob, bytes):
                blob = blob.decode("utf-8", "replace")
            with open(out, "w") as f:
                f.write(blob if isinstance(blob, str) else json.dumps(blob))
            print("wrote", out, len(blob))
        except Exception as e:  # noqa
            print(tool, "failed:", repr(e)[:200])


if __name__ == "__main__":
    main()
