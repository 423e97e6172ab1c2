"""Empirical check: a rigid gauge correction applied between chunks must
leave subsequent tracking (inlier counts) EXACTLY invariant — the map and
pose move together, so every reprojection is unchanged. If this probe shows
inlier drift, the application path leaks somewhere (r5 loop-closing
investigation)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ssvio_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=2.0)

import sys

import jax.numpy as jnp
import numpy as np


from scripts.repro_loop5 import small_settings
from ssvio_tpu.dataio import synthetic
from ssvio_tpu.ops import se3
from ssvio_tpu.system import System

s = small_settings()
s.loop_threshold_higher = 2.0     # BoW scores are <= 1: no candidate can
                                  # ever fire — isolates the synthetic C
n = 120
world = synthetic.SyntheticWorld(seed=11, wall_x=16.0, ceiling_y=-5.0)
circ = synthetic.loop_trajectory(n, radius=6.0)
poses = np.concatenate([circ, circ[:40]], axis=0)
L, R = synthetic.render_stereo_sequence(
    world, poses, s.cam_left.fx, s.cam_left.fy, s.cam_left.cx,
    s.cam_left.cy, s.baseline, s.image_width, s.image_height)

sys_ = System(s, enable_backend=True, enable_loop_closing=True)
CH = 10
for c in range(0, 100, CH):
    sys_.run_chunk(L[c:c + CH], R[c:c + CH])

snap = dict(map=sys_.map, feat=sys_.feat, T_cw=sys_.T_cw,
            rel_motion=sys_.rel_motion, last_pyr=sys_.last_pyr,
            status=sys_.status, status_dev=sys_._status_dev,
            frame_id=sys_.frame_id)

def run_tail(tag):
    healths = []
    for c in range(100, 160, CH):
        sys_.run_chunk(L[c:c + CH], R[c:c + CH])
        healths.append(sys_.track_health)
    print(f"{tag}: healths={healths}  T_cw_t={np.asarray(sys_.T_cw)[:, 3]}")
    return healths

base = run_tail("baseline       ")

# restore + apply a rigid correction, then run the same frames
for k, v in snap.items():
    if k == "status_dev":
        sys_._status_dev = v
    else:
        setattr(sys_, k, v)
C = np.asarray(se3.exp(jnp.asarray([0.4, -0.2, 0.3, 0.03, 0.05, -0.02],
                                   jnp.float32)))
m = sys_.map
kf_new, lm_new = sys_.loopclosing._correct_active(
    m.kf_pose, m.lm_pos, m.lm_valid, jnp.asarray(C))
sys_.apply_loop_correction(sys_.loopclosing,
                           m._replace(kf_pose=kf_new, lm_pos=lm_new), C)
corr = run_tail("after rigid C  ")

print("max health delta:", max(abs(a - b) for a, b in zip(base, corr)))

# ---- pipelined variant: dispatch chunk k+1 FIRST, apply C while it is in
# flight (the dispatch-ahead path), then collect and continue
for k, v in snap.items():
    if k == "status_dev":
        sys_._status_dev = v
    else:
        setattr(sys_, k, v)
sys_._gauge_events = list(sys_._gauge_events)
h = sys_.dispatch_chunk(L[100:110], R[100:110])
m = sys_.map                      # in-flight chunk's lazy output carry
kf_new, lm_new = sys_.loopclosing._correct_active(
    m.kf_pose, m.lm_pos, m.lm_valid, jnp.asarray(C))
sys_.apply_loop_correction(sys_.loopclosing,
                           m._replace(kf_pose=kf_new, lm_pos=lm_new), C)
sys_.collect_chunk(h)
healths = [sys_.track_health]
for c in range(110, 160, CH):
    sys_.run_chunk(L[c:c + CH], R[c:c + CH])
    healths.append(sys_.track_health)
print(f"pipelined C    : healths={healths}  "
      f"T_cw_t={np.asarray(sys_.T_cw)[:, 3]}")
print("max health delta (pipelined):",
      max(abs(a - b) for a, b in zip(base, healths)))
